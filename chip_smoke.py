#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card (an H100).

    python3 chip_smoke.py [--against DIR [--steps ARCH ...]]

Phases; any failure exits non-zero:
1. device: name, count, ``nvidia-smi`` name and power limit;
2. build the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together), and check with
   ``cuobjdump -sass`` that the tensor-core kernels hold tensor-core
   instructions;
3. hold each kernel (GQA decode attention, MLA latent decode, dense and
   paged; the SSD and gated-delta-rule prefill scans; the two scans'
   backward kernels, with and without the final state's cotangent, two
   calls bitwise equal) against its plain PyTorch version on the card, at
   the main paths' shapes and others (GQA
   also with the logit softcap and the sliding window, whole splits and
   pages below the window among them, and at the replica banks' folded
   batches of phase 11, B 512 x H 8 / D 256 and B 128 x H 36 / D 64, timed
   in fp32 and bf16; the backward kernels at the training
   shapes of mamba2-780m, zamba2-1.2b and gdn-4b, off the chunk and, for
   the SSD one, at a P that 64 does not divide), and
   time kernel, plain version and, where one PyTorch call computes the same
   function, that call (``F.scaled_dot_product_attention``; yardstick only,
   the port never calls it) beside the bound; kernels 1 and 4's
   log-sum-exp output (``return_lse``) against their twins at the main
   cases and at a cache shard's rows (valid_len 0, past L, a window
   starting past L); kernel 3 and its backward with ``ssm_groups`` B/C
   groups (G 8 and 80 at mamba2-4b's widths and 512-token bucket, fp32 and
   bf16, launched once each and held against the plain versions; bf16
   device ms of G 1, 8 and 80 beside their bounds); the causal
   prefill-attention kernel in bf16 against its twin at minitron-4b's 4096
   and 2048 buckets, gemma2-9b's softcapped and windowed local layers over
   8192 tokens, gemma-2b's and minicpm-2b's heads and a batch of 3, timed
   beside its bound, the plain path and SDPA; the sampling bits
   (``serving.prng.uniform``) on the card equal the CPU's for several keys
   and one (8, 256000) draw, and that draw's device time;
4. for each served model -- full-width gemma-2b (GQA), minitron-4b-mla
   (absorbed MLA), mamba2-4b (Mamba2 SSD), gdn-4b (Gated DeltaNet),
   qwen3-4b (GQA, G = 4), minitron-4b (GQA, G = 3), gemma2-9b (GQA with
   softcaps and a sliding window), deepseek-v2-lite-16b (absorbed MLA and
   routed MoE), zamba2-1.2b (Mamba2 with a shared attention block) and
   nemotron-4-15b (GQA, G = 6, squared-ReLU MLP, 15.6 B params),
   random weights from a seeded generator -- serve through
   ``ServingEngine`` with a lock-mode
   ``ClockController``, dense then paged, each with the pool's decode step
   replayed from a CUDA graph (after one eager step), and for gemma-2b on
   the dense layout then eager on the same prompts: greedy streams equal, step times,
   profiles and capture cost side by side, kernel launches counted (a model's decode kernel
   once per attention layer and decode step, as eager launches plus graph
   replays x the launches captured; its prefill scan once per recurrent
   layer and prefill call, ``prefill_attention`` once per self-attention
   layer and bf16 prefill call; every other kernel never); one decode step's
   logits graph vs eager on copies of one cache, and kernel path vs plain
   path (for the recurrent models the prefill logits, the final states and
   one decode step after them); then fp32 graph engines (dense, paged)
   whose greedy streams must agree; for gemma-2b also the dense graph and
   eager runs with every third prompt sampled at temperature 0.7 (the
   reference's key splits, the uniform drawn on the card): the two sampled
   streams equal; for gemma2-9b also two
   requests of ~4200 tokens in a cache of 8192, past its 4096 window,
   dense and paged, kernel vs plain logits over three decode steps;
4b. ``[mesh]``: the multi-device layer on a one-rank NCCL group: its (1, 1)
   ``make_host_mesh()``, ``compressed_psum`` against int8
   quantise-then-dequantise, full-width gemma-2b in bf16 (phase 4's batch,
   prompts and 32 greedy steps) with params, cache and inputs laid out by
   the sharding rules as DTensors, kernel 1 launched inside ``local_map``,
   against the same steps on plain tensors (tokens equal, logits within
   LOGIT_ATOL_BF16, 18 launches a step, host ms a step); then the pod dry
   run's ``POD_CELLS`` on the 16 x 16 and 2 x 16 x 16 meshes (a fake
   process group on the CPU, in a process started with the run), one line
   a cell;
5. ``[cluster]``: the phase-disaggregated ``Cluster`` (a prefill pool handing
   its cache rows to a paged decode pool whose step is a CUDA graph) on
   ``serve_cluster``'s recipe at full width, driven through the recipe's
   own ``run``, bf16, minicpm-2b and mamba2-780m under the modes default /
   cap / lock: the recipe's ordering (lock >= cap tokens/J, the cap never
   engaged on decode and at the default clock), completion, traffic and
   occupancy asserted; lock served again eagerly, greedy streams equal;
6. ``[trace]``: ``serve_trace``'s 60-request smoke recipe through its own
   ``run`` (``Cluster.from_spec`` on a virtual clock, the event engine),
   full width, the modes default / cap / lock / slo: its claims and a
   deterministic second replay asserted;
7. ``[fleet]``: ``serve_fleet``'s smoke recipe through its own ``run``
   (qwen3-4b, minitron-4b-mla and gdn-4b paged, six pools on one card,
   behind jsq / energy / affinity under lock and slo; the all-qwen3-4b
   fleet on one weight set; one replica drained; the repeat), 120 diurnal
   requests a replay on the event engine: its claims asserted;
8. ``[autoscale]``: ``serve_autoscale``'s smoke recipe through its own
   ``run`` (four dense qwen3-4b replicas on one weight set, static4 /
   queue / schedule, the valley replay, the repeat; replicas power down
   and up under captured decode graphs): its claims asserted, each
   replay's ``ScaleEvent``s, joules, ramp TTFT and dispatches printed;
9. ``[prefix]``: ``serve_prefix``'s smoke recipe through its own ``run``
   (gemma-2b; dense, paged and copy-on-write prefix-sharing fleets over
   three shares of tree-shaped traffic, the routing pair, a repeat replay)
   on the event engine: its claims asserted, kernel 2's launches over
   block tables whose rows share pages counted; where the bf16 streams of
   the three configurations part, the first parting is printed and the
   phase fails;
10. ``[events]``: ``serve_events``' fleet (16 gemma-2b replicas on one
   weight set, 32 pools on one card, each fused group stepped as one step
   over a replica bank) on its wave trace cut to 256 requests, twice
   (equal sha256, fused decode coverage), then its burst trace on the
   event engine against the barrier; then the fold measurement in bf16
   (one decode step folded to batch K x 8 against the K member steps, K 4,
   16 and 64: logits bit for bit, also with kernel 1's split plan pinned
   to the member's batch; eager times, and a bank's graph replay against
   the K member graphs' replays);
11. ``[scale]``: ``serve_scale``'s recipe through its own ``run``, 88
   gemma-2b + 12 minicpm-2b replicas at full width in fp32 (200 pools on
   one card), traces cut to whole waves (``SCALE_COUNTS``): every gate of
   the recipe (completion, two equal replays, aligned fused coverage,
   dispatches, batched sha256 == tuple sha256, the quantum, batched faster
   than tuple per fused call at g >= 8), each replay's ``EngineStats`` and
   bank steps, captures and replays; the fold measurement in fp32. In
   phases 5-11 every run counts its
   kernel launches across the prefill and decode pools and the replica
   banks (decode kernel layers x (each pool's own decode steps + each
   bank step), as eager launches + replays x captured launches; scan
   layers x prefill calls, a batched prefill one call; every other kernel
   never), and each phase prints its seconds;
12. ``[paper]``: every analytic table and figure driver of the paper
   (Table 1, Figs 1-4, the hypotheses, the policy table, ``tpu_native`` on
   the v5e, ``roofline_report``) through its own ``run``, the recipes'
   verdicts asserted; ``roofline_report`` over the one-card dry run of
   every (arch x shape) cell on meta tensors (``repro_torch.launch.dryrun``,
   run on the CPU in a process of its own started with the run: 40
   records, 32 ok and 8 skipped; the report's one-card table of 32 cells,
   priced with ``H100_SXM``); the dry run held against the card: gemma-2b's
   decode cell at phase 4's shape (B 8, a cache of 1024) counts the
   argument bytes the card holds and as many kernel-1 calls as one
   ``decode_step`` launches there (18), and phase 13's train shape (8 x
   512) the argument bytes of the card's train state and batch, with the
   counted FLOPs and temp estimate printed beside the card's figures;
   ``tpu_native``'s ``H100_SXM`` table printed;
   ``kernels_micro`` on the card (four fp32 kernels against their plain
   versions, CUDA-event times), its launches counted; the card's clock and
   power surface printed beside ``H100_SXM``'s fields;
13. ``[train]``: the training path through ``run_training`` at full width
   (gemma-2b, bf16, batch 8 x 512 tokens, 20 AdamW + WSD steps with remat
   and the chunked loss): falling finite losses, a finite nonzero gradient
   on every parameter leaf at step 1, step ms, tokens/s, the model-FLOP
   share of the bf16 peak and peak memory; on one batch and the same
   weights remat off against on and two microbatches against one; 10 steps
   with int8 compression; ``forward``'s logits against ``prefill`` and a
   ``decode_step`` (kernel 1); at reduced width a restart from a checkpoint
   against a straight run, one step of llama-3.2-vision-11b
   (cross-attention) and of musicgen-large (embedding inputs); no decode or
   scan kernel launched but kernel 1's 18 in the decode step; at full width,
   bf16, a prefill and three decode steps of llama-3.2-vision-11b and of
   musicgen-large, kernel 1 against the plain path on the logits, launched
   once per self-attention layer and step; then the
   recurrent kinds at full width through kernels 3 and 6 and their
   backward kernels: mamba2-780m through ``run_training`` (10 steps of
   8 x 512, every leaf's step-1 gradient finite and nonzero, falling
   losses), 3 steps of gdn-4b at 4 x 512 and one of zamba2-1.2b, each with
   its launches counted (a recurrent layer's forward scan twice a step, its
   backward once), step ms, tokens/s, peak memory and a profiled step;
14. ``[examples]``: the port's examples and scripts on the card at their
   own sizes (``repro_torch.examples.{characterize_paper, quickstart,
   serve_decode_pool, train_wsd}``, ``repro_torch.scripts.{calibrate,
   smoke_models}``): the cap never engaged on decode and the lock saving
   more than 20 %, finite losses, every block kind's prefill + decode
   through the kernels against the training forward;
15. print the kernels' JSON line and, last, ``{"ok": true, "device": {...}}``.

With ``--against DIR`` it runs none of these phases: it builds the kernels
of this checkout and of the checkout in DIR (another commit, unpacked with
``git archive``) and times each kernel's main case for both on the same
inputs, in three rounds of turns, one JSON line per kernel with each
side's median; with ``--steps ARCH ...`` also each ARCH's phase-4 bf16
decode step (graph), dense and paged, for both checkouts in turns (DIR,
this, this, DIR), each turn a process of its own: step ms, replay device
ms, profiled device ms and kernels a step, each side's mean.

Imports neither ``jax`` nor ``repro``. Exits 2 without a CUDA card or outside
a checkout of the repository.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import json
import math
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

TOL = {"float32": dict(atol=5e-5, rtol=5e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# the SSD and GDN scans: tests/test_kernels.py's tolerances for them
SCAN_TOL = {"float32": dict(atol=2e-4, rtol=2e-4), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# bf16 model logits, kernel path vs plain path on the same state, per served
# model: kernel and plain version sum in other orders and round their bf16
# outputs differently (every bf16 decode kernel, dense and paged, rounds P to
# bf16 for P.V, as the JAX model does, where the plain versions keep it
# fp32), and every layer carries the difference on to the logits: 18 layers
# for gemma-2b, 32 for minitron-4b-mla and minitron-4b, 36 for qwen3-4b
# (gemma-2b's 0.25 was set at ~2.5x its observed 0.094; qwen3-4b's and
# minitron-4b's likewise, from their observed 0.094 and 0.117)
# gemma2-9b's final softcap bounds its logits to +-30; deepseek-v2-lite-16b
# as minitron-4b-mla; zamba2-1.2b as the recurrent models; nemotron-4-15b
# (32 layers, G 6, squared-ReLU MLP) as its pruned descendant minitron-4b;
# the full-width llama-3.2-vision-11b and musicgen-large steps of phase 13
# (GQA, kernel 1) at the GQA models' 0.25
LOGIT_ATOL_BF16 = {"gemma-2b": 0.25, "minitron-4b-mla": 0.5, "mamba2-4b": 0.5, "gdn-4b": 0.5,
                   "qwen3-4b": 0.25, "minitron-4b": 0.3, "gemma2-9b": 0.25,
                   "deepseek-v2-lite-16b": 0.5, "zamba2-1.2b": 0.5, "nemotron-4-15b": 0.3,
                   "llama-3.2-vision-11b": 0.25, "musicgen-large": 0.25}
# The recurrent models' kernels sit in prefill, where a difference at one
# position is carried by the state to every later one, at every layer. In
# bf16 these random-weight stacks amplify any rounding difference: a plain
# prefill whose layer-0 scan output is perturbed by a quarter of a bf16 ulp
# ends at least as far from the unperturbed one as the kernel path does (the noise
# floor, measured in each run). So at bf16 the kernel is held against its
# plain version at every layer, on the same inputs (``ScanTee``, at
# SCAN_TOL), and the end-to-end logits within max(LOGIT_ATOL_BF16, twice the
# noise floor); end to end the paths are held in fp32, where the stack does
# not amplify: logits and one decode step after within LOGIT_ATOL_FP32
# (two summation orders over 36 / 64 layers), argmax equal, final states
# within LOGIT_ATOL_FP32 x the largest state entry.
LOGIT_ATOL_FP32 = 1e-3
L2_BYTES = 50 * 2**20
MLA_SCALE = 1.0 / math.sqrt(128 + 64)      # minitron-4b-mla: 1/sqrt(nope + rope)
# every kernel whose launches a main path counts
COUNTED = ("decode_attention", "paged_decode_attention",
           "mla_latent_decode", "mla_paged_latent_decode", "ssd_scan", "gdn_scan",
           "ssd_scan_bwd", "gdn_scan_bwd", "prefill_attention")
SOURCES = {
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                         "src/repro/kernels/decode_attn/decode_attn.py:162"),
    "paged_decode_attention": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                               "src/repro/kernels/decode_attn/decode_attn.py:107"),
    "mla_latent_decode": ("src/repro_torch/kernels/csrc/mla_decode.cu",
                          "src/repro/kernels/mla_decode/mla_decode.py:164"),
    "mla_paged_latent_decode": ("src/repro_torch/kernels/csrc/mla_decode.cu",
                                "src/repro/kernels/mla_decode/mla_decode.py:110"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu", "src/repro/kernels/ssd/ssd.py:73"),
    "gdn_scan": ("src/repro_torch/kernels/csrc/gdn_scan.cu", "src/repro/kernels/gdn/gdn.py:62"),
    # the backward kernels replace no TPU kernel (the Pallas scans have no
    # backward): "replaces" names the jnp scan whose jax.grad the reference
    # takes where the port runs them
    "ssd_scan_bwd": ("src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                     "src/repro/models/ssm.py:74"),
    "gdn_scan_bwd": ("src/repro_torch/kernels/csrc/gdn_scan_bwd.cu",
                     "src/repro/models/gdn.py:64"),
    # no Pallas kernel: the jnp blocked attention the reference's prefill
    # takes for long prompts
    "prefill_attention": ("src/repro_torch/kernels/csrc/prefill_attn.cu",
                          "src/repro/models/flash.py:64"),
}
# served model -> its kernels: "decode" (dense kernel, paged kernel), launched
# once per block of a decode kind and decode step; "prefill", each launched
# once per prefill call and block of its kinds: a scan per block of a scan
# kind, ``prefill_attention`` per self-attention block where the kernel
# takes the call (bf16, a head dim it was built for: ``_n_layers``)
ATTN_PREFILL = ("prefill_attention",)
MODELS = {
    "gemma-2b": {"decode": ("decode_attention", "paged_decode_attention"),
                 "prefill": ATTN_PREFILL},
    "minitron-4b-mla": {"decode": ("mla_latent_decode", "mla_paged_latent_decode"),
                        "prefill": ()},
    "mamba2-4b": {"decode": None, "prefill": ("ssd_scan",)},
    "gdn-4b": {"decode": None, "prefill": ("gdn_scan",)},
    "qwen3-4b": {"decode": ("decode_attention", "paged_decode_attention"),
                 "prefill": ATTN_PREFILL},
    "minitron-4b": {"decode": ("decode_attention", "paged_decode_attention"),
                    "prefill": ATTN_PREFILL},
    "gemma2-9b": {"decode": ("decode_attention", "paged_decode_attention"),
                  "prefill": ATTN_PREFILL},
    "deepseek-v2-lite-16b": {"decode": ("mla_latent_decode", "mla_paged_latent_decode"),
                             "prefill": ()},
    "zamba2-1.2b": {"decode": ("decode_attention", "paged_decode_attention"),
                    "prefill": ("ssd_scan",) + ATTN_PREFILL},
    "nemotron-4-15b": {"decode": ("decode_attention", "paged_decode_attention"),
                       "prefill": ATTN_PREFILL},
}
# the long-context check of the windowed model (phase 4): two requests of
# ~4200 tokens in a cache of max_seq_len, past the 4096 window of its local
# layers, kernel vs plain logits at `checks` decode steps
LONG_CONTEXT = {"gemma2-9b": {"max_seq_len": 8192, "prompt_tokens": (4150, 4250), "checks": 3}}
# phases 5-7 (the disaggregated serving stack): the archs served there that
# phase 4 does not serve, with their kernels as in MODELS
STACK_MODELS = {
    "minicpm-2b": {"decode": ("decode_attention", "paged_decode_attention"),
                   "prefill": ATTN_PREFILL},
    "mamba2-780m": {"decode": None, "prefill": ("ssd_scan",)},
}
KERNELS_OF = {**MODELS, **STACK_MODELS}
# serve_fleet's claim that energy-aware routing spends no more joules than
# jsq fails on the port's seed-0 weights, at full width and at reduced
# width alike, and holds on the reference's weights, on which the CPU tests
# assert it (ROADMAP.md section 3, item 7): ``[fleet]`` prints its figures
# and asserts every other check of the recipe
FLEET_CAVEAT = "energy-aware routing spent"
# the scans' plain versions run ~10 PyTorch ops per token: time fewer calls
PLAIN_SCAN_REPS = 3
# phase 4's runs per layout (paged?): the graph run, and the eager run on the
# dense layout only (graph == eager is held there; the eager step's code is
# the same for both layouts). In fp32 the graph runs only (dense == paged):
# the eager fp32 run, which [scale] paid for, held graph == eager a second
# time where bf16 holds it already. The bf16 eager serving run is
# EAGER_ARCHS' only (the cut for [mesh]): every model's step graph == eager
# stays held on copies of one cache (``step_logits``)
EAGER_LAYOUTS = {False: (True, False), True: (True,)}
EAGER_ARCHS = ("gemma-2b",)
FP32_LAYOUTS = {False: (True,), True: (True,)}


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


class SmiSampler:
    """``nvidia-smi`` power.draw and clocks.sm sampled every 100 ms while
    the block runs (a child process, stopped on exit)."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=power.draw,clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=10)
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue
        self.samples = rows
        return False

    def summary(self) -> dict:
        if not self.samples:
            return {"samples": 0}
        p = [r[0] for r in self.samples]
        c = [r[1] for r in self.samples]
        return {"samples": len(p), "power_w_mean": sum(p) / len(p), "power_w_max": max(p),
                "clock_sm_mhz_mean": sum(c) / len(c), "clock_sm_mhz_min": min(c)}


def cuda_time_ms(torch, fn, arg_sets, reps: int = 40) -> tuple:
    """(device ms, eager ms) per call of ``fn(*args)``, cycling through
    ``arg_sets`` (copies of the inputs larger than L2 together, so each call
    finds its inputs cold, as a decode step does). Device time replays the
    calls captured in a CUDA graph, so host launch cost is left out; eager
    time is the same loop launched from Python, CUDA events around both."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / reps
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps), eager


def cold_sets(inputs) -> list:
    """``inputs`` and enough copies of them that their floating-point
    tensors together exceed L2 twice, for ``cuda_time_ms`` to cycle through."""
    per_set = sum(t.numel() * t.element_size() for t in inputs if t.is_floating_point())
    n_sets = max(2, -(-2 * L2_BYTES // per_set))
    return [inputs] + [tuple(t.clone() for t in inputs) for _ in range(n_sets - 1)]


# GQA decode attention: (name, paged, B, H, KV, Dk, Dv, L, bs, main, softcap,
# window), softcap and window 0 unless given; the first of each kind is the
# gemma-2b decode shape at batch 8 and max_seq_len 1024, the one timed
Gqa = collections.namedtuple("Gqa", "name paged b h kv dk dv l bs main softcap window",
                             defaults=(0.0, 0))
KERNEL_CASES = (
    Gqa("decode_attention", False, 8, 8, 1, 256, 256, 1024, 0, True),
    Gqa("decode_attention", False, 2, 8, 2, 32, 16, 128, 0, False),     # GQA, Dk != Dv
    Gqa("decode_attention", False, 3, 6, 6, 16, 16, 96, 0, False),      # MHA
    Gqa("decode_attention", False, 4, 32, 8, 128, 128, 512, 0, False),  # qwen3-4b heads
    Gqa("decode_attention", False, 2, 16, 1, 64, 64, 300, 0, False),    # G = 16
    Gqa("paged_decode_attention", True, 8, 8, 1, 256, 256, 1024, 16, True),
    Gqa("paged_decode_attention", True, 2, 8, 2, 32, 16, 48, 16, False),
    Gqa("paged_decode_attention", True, 3, 6, 6, 16, 16, 32, 8, False),
    Gqa("paged_decode_attention", True, 8, 8, 1, 256, 256, 1024, 8, False),   # pages < a step
    Gqa("paged_decode_attention", True, 4, 24, 8, 128, 128, 512, 32, False),  # minitron-4b: G 3
    Gqa("decode_attention", False, 12, 36, 36, 64, 64, 128, 0, False),    # minicpm-2b: G = 1
    Gqa("paged_decode_attention", True, 12, 36, 36, 64, 64, 128, 8, False),   # its [cluster] shape
    Gqa("decode_attention", False, 8, 8, 1, 256, 256, 64, 0, False),      # the [events] shape
    Gqa("paged_decode_attention", True, 8, 8, 1, 256, 256, 128, 16, False),   # the [prefix] shape
    # zamba2-1.2b's shared block as phase 4 serves it (G 1, D 64)
    Gqa("decode_attention", False, 8, 32, 32, 64, 64, 1024, 0, False),
    Gqa("paged_decode_attention", True, 8, 32, 32, 64, 64, 1024, 16, False),
    # the logit softcap and the sliding window. gemma2-9b's heads (G 2, D
    # 256) with softcap 50, as phase 4 serves them; window 256 at L 1024,
    # where whole splits and whole pages lie below the window (tc plan: 3
    # splits of 384 keys; fp32: 9 of 114); window 100, which starts inside
    # a page and inside a 16-key step, at gemma-2b's G 8 (16 splits of 64);
    # zamba2's heads under a window; both at gemma2-9b's long context (its
    # 4096 window in a cache of 8192)
    Gqa("decode_attention", False, 8, 16, 8, 256, 256, 1024, 0, False, 50.0),
    Gqa("paged_decode_attention", True, 8, 16, 8, 256, 256, 1024, 16, False, 50.0),
    Gqa("decode_attention", False, 8, 16, 8, 256, 256, 1024, 0, False, 0.0, 256),
    Gqa("paged_decode_attention", True, 8, 16, 8, 256, 256, 1024, 16, False, 0.0, 256),
    Gqa("decode_attention", False, 8, 8, 1, 256, 256, 1024, 0, False, 0.0, 100),
    Gqa("paged_decode_attention", True, 8, 8, 1, 256, 256, 1024, 16, False, 0.0, 100),
    Gqa("paged_decode_attention", True, 8, 8, 1, 256, 256, 1024, 8, False, 50.0, 100),
    Gqa("decode_attention", False, 2, 32, 32, 64, 64, 256, 0, False, 0.0, 64),
    Gqa("decode_attention", False, 8, 16, 8, 256, 256, 8192, 0, False, 50.0, 4096),
    Gqa("paged_decode_attention", True, 8, 16, 8, 256, 256, 8192, 16, False, 50.0, 4096),
    # the event engine's replica banks ([scale]): a fused group folded to
    # one batch of p2 x 8 rows, gemma-2b's 64 members and minicpm-2b's 16
    Gqa("decode_attention", False, 512, 8, 1, 256, 256, 64, 0, False),
    Gqa("decode_attention", False, 128, 36, 36, 64, 64, 64, 0, False),
)
# the folded cases: timed in fp32 (the [scale] run's dtype) and bf16
FOLDED = tuple(c for c in KERNEL_CASES if c.b >= 128)
# not main cases, but timed (and printed) as well: minicpm-2b's decode at
# the [cluster] phase's shapes, where one query row fills a 16-row MMA tile,
# gemma2-9b's long context and the folded cases
TIMED_EXTRA = tuple(c for c in KERNEL_CASES
                    if (c.h, c.l) == (36, 128) or c.l == 8192 or c in FOLDED)
# kernel 2 over block tables whose rows share pages, at the [prefix] shape
# (gemma-2b, bs 16, max_seq_len 128): per row its valid_len and its table
# entries (page ids); rows 0-4 share a three-page trunk, rows 3 and 4 also
# the page after it (a boundary tail), rows 5-7 hold private pages
ALIASED_VALID = (128, 113, 60, 52, 56, 17, 33, 1)
ALIASED_TABLES = (
    (1, 2, 3, 5, 6, 7, 8, 9), (1, 2, 3, 10, 11, 12, 13, 14), (1, 2, 3, 15),
    (1, 2, 3, 4), (1, 2, 3, 4), (16, 17), (18, 19, 20), (21,),
)
# MLA latent decode: (name, paged, B, H, rank, rope, L, bs, main); the first
# of each kind is the minitron-4b-mla decode shape at batch 8 and
# max_seq_len 1024, the one timed
Mla = collections.namedtuple("Mla", "name paged b h rank rope l bs main")
MLA_CASES = (
    Mla("mla_latent_decode", False, 8, 24, 512, 64, 1024, 0, True),
    Mla("mla_latent_decode", False, 8, 4, 32, 8, 128, 0, False),        # reduced config
    Mla("mla_latent_decode", False, 8, 16, 512, 64, 512, 0, False),     # deepseek-v2-lite heads
    Mla("mla_latent_decode", False, 4, 128, 512, 64, 256, 0, False),    # deepseek-v2-236b heads
    Mla("mla_latent_decode", False, 8, 16, 512, 64, 1024, 0, False),    # deepseek-v2-lite served
    Mla("mla_paged_latent_decode", True, 8, 24, 512, 64, 1024, 16, True),
    Mla("mla_paged_latent_decode", True, 8, 4, 32, 8, 128, 16, False),
    Mla("mla_paged_latent_decode", True, 8, 16, 512, 64, 512, 16, False),
    Mla("mla_paged_latent_decode", True, 4, 128, 512, 64, 256, 16, False),
    Mla("mla_paged_latent_decode", True, 8, 16, 512, 64, 1024, 16, False),
)


# SSD scan: (B, S, H, P, N, main); the first is the mamba2-4b prefill of a
# 512-token bucket, the one timed (bf16, the model's compute dtype)
SSD_CASES = (
    (1, 512, 80, 64, 128, True),
    (2, 128, 4, 32, 16, False),      # reduced mamba2-4b
    (1, 300, 80, 64, 128, False),    # not a chunk multiple: ssd_prefill pads
    (2, 256, 80, 64, 128, False),    # B = 2
    (1, 32, 48, 64, 128, False),     # mamba2-780m, the [trace] phase's short prompts
    (1, 512, 48, 64, 128, False),    # mamba2-780m, a 512-token bucket
)
# GDN scan: (B, S, H, K, main); the first is the gdn-4b prefill of a
# 512-token bucket, the one timed (fp32, as the model calls it)
GDN_CASES = (
    (1, 512, 20, 128, True),
    (2, 64, 2, 16, False),           # reduced gdn-4b
    (1, 300, 20, 128, False),        # not a chunk multiple: gdn_prefill pads
    (2, 256, 20, 128, False),        # B = 2
)
SCAN_TIMED_DTYPE = {"ssd_scan": "bfloat16", "gdn_scan": "float32"}
SCAN_NO_LIBRARY = "no single PyTorch call computes a selective scan or a delta rule"
# the scans' backward kernels: (B, S, H, P, N, main) and (B, S, H, K, main);
# the first of each is the training shape of the model [train] trains, the
# one timed (mamba2-780m at 8 x 512 in bf16, gdn-4b at 4 x 512 in fp32, as
# the models call the scans); S off the chunk goes through the prefill
# wrapper's padding and autograd, against the twin on the unpadded inputs
SSD_BWD_CASES = (
    (8, 512, 48, 64, 128, True),     # mamba2-780m
    (8, 512, 64, 64, 64, False),     # zamba2-1.2b (N 64)
    (2, 300, 48, 64, 128, False),    # not a chunk multiple: through ssd_prefill
    (2, 128, 4, 96, 64, False),      # 64 does not divide P: the bf16 kernel's 32-row CTAs
)
GDN_BWD_CASES = (
    (4, 512, 20, 128, True),         # gdn-4b
    (2, 300, 20, 128, False),        # not a chunk multiple: through gdn_prefill
    (2, 96, 4, 64, False),           # K 64: another instantiation of the kernels
)
SCAN_BWD_TIMED_DTYPE = {"ssd_scan_bwd": "bfloat16", "gdn_scan_bwd": "float32"}
# each gradient of a backward kernel against its twin, as max |diff| / max
# |twin| (the scans' tolerances: bf16 gradients are returned in bf16)
SCAN_BWD_RTOL = {"float32": 2e-4, "bfloat16": 2e-2}
SCAN_BWD_NO_LIBRARY = "no PyTorch call computes the backward of either scan"


# ssm_groups > 1 through kernel 3 and its backward: mamba2-4b's widths and
# 512-token bucket (B, S, H, P, N) with G groups of B/C, each head reading
# group h // (H / G); G = 1 is timed beside them in the same call
SSD_GROUP_SHAPE = (1, 512, 80, 64, 128)
SSD_GROUPS = (8, 80)
# the sampling draw: keys for the device-vs-CPU bits check, and the shape of
# one draw timed (batch 8 x gemma-2b's 256 000-entry vocabulary)
PRNG_SEEDS = (0, 1, 42, 2**31 - 1)
PRNG_DRAW = (8, 256000)
# phase 4's sampled gemma-2b run: every third prompt at this temperature
SAMPLED_ARCH = "gemma-2b"
SAMPLED_TEMPERATURE = 0.7


def case_seed(case) -> int:
    """The seed of a kernel case's inputs, made from the case itself, so
    that adding a case leaves every other case's inputs as they were; a GQA
    case's softcap and window enter it only where one of them is set."""
    key = tuple(case)
    if isinstance(case, Gqa) and not (case.softcap or case.window):
        key = key[:-2]
    return zlib.crc32(repr(key).encode())


def case_kwargs(case) -> dict:
    """A decode case's keyword arguments: the scale, and a GQA case's
    softcap and window where one of them is set."""
    if isinstance(case, Mla):
        return {"scale": MLA_SCALE}
    kw = {"scale": 1.0 / math.sqrt(case.dk)}
    if case.softcap or case.window:
        kw.update(softcap=case.softcap, window=case.window)
    return kw


CASE_LABELS = {"b": "B", "h": "H", "kv": "KV", "dk": "Dk", "dv": "Dv", "l": "L"}


def case_label(case) -> str:
    """A decode case's shape, its block size, softcap and window where set."""
    return " ".join(f"{CASE_LABELS.get(f, f)}={getattr(case, f)}" for f in case._fields[2:]
                    if f != "main" and (f not in ("bs", "softcap", "window") or getattr(case, f)))


def _valid_lens(torch, g, b, l):
    """Ragged valid_len including 1 and L."""
    valid = torch.randint(1, l + 1, (b,), generator=g, device="cuda")
    valid[0] = 1
    if b > 1:
        valid[1] = l
    return valid.to(torch.int32)


def _tables(torch, g, valid, bs, nb, n_pages):
    """Distinct live pages per request, shuffled; null page 0 past valid_len."""
    perm = torch.randperm(n_pages - 1, generator=g, device="cuda") + 1
    tables = torch.zeros((valid.shape[0], nb), dtype=torch.int32, device="cuda")
    used = 0
    for i, n in enumerate(((valid + bs - 1) // bs).tolist()):
        tables[i, :n] = perm[used:used + n].to(torch.int32)
        used += n
    return tables


def make_inputs(torch, case, dtype, seed):
    """Seeded inputs of one GQA case, in the kernel's argument order."""
    paged, b, h, kv, dk, dv, l, bs = case[1:9]
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    valid = _valid_lens(torch, g, b, l)
    q = torch.randn((b, h, dk), generator=g, device=dev).to(dtype)
    if not paged:
        k = torch.randn((b, l, kv, dk), generator=g, device=dev).to(dtype)
        v = torch.randn((b, l, kv, dv), generator=g, device=dev).to(dtype)
        return (q, k, v, valid)
    nb = l // bs
    n_pages = 1 + b * nb
    kp = torch.randn((n_pages, bs, kv, dk), generator=g, device=dev).to(dtype)
    vp = torch.randn((n_pages, bs, kv, dv), generator=g, device=dev).to(dtype)
    return (q, kp, vp, _tables(torch, g, valid, bs, nb, n_pages), valid)


def aliased_page_inputs(torch, dtype, h=8, kv=1, d=256, bs=16, nb=8, seed=29):
    """Kernel 2's inputs over ``ALIASED_TABLES``: (kernel inputs, plain
    inputs). In the kernel's, every page no entry below ceil(valid_len /
    bs) names is NaN (entries past it name a NaN page), and so is every row
    of a named page past the longest valid_len reading it, so a read of
    any of them shows; the plain version's have those entries on the null
    page 0 and finite rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    valid = torch.tensor(ALIASED_VALID, dtype=torch.int32, device="cuda")
    b = len(ALIASED_VALID)
    n_pages = 2 + max(max(t) for t in ALIASED_TABLES)          # + the NaN page
    kp = torch.randn((n_pages, bs, kv, d), generator=g, device="cuda")
    vp = torch.randn((n_pages, bs, kv, d), generator=g, device="cuda")
    kp[0] = vp[0] = 0
    tables = torch.zeros((b, nb), dtype=torch.int32, device="cuda")
    nan_tables = torch.full((b, nb), n_pages - 1, dtype=torch.int32, device="cuda")
    rows_read = [0] * n_pages
    for i, (vl, row) in enumerate(zip(ALIASED_VALID, ALIASED_TABLES)):
        assert len(row) == -(-vl // bs)
        tables[i, :len(row)] = nan_tables[i, :len(row)] = torch.tensor(row)
        for j, page in enumerate(row):
            rows_read[page] = max(rows_read[page], min(bs, vl - j * bs))
    nan_kp, nan_vp = kp.clone(), vp.clone()
    for page in range(1, n_pages):
        nan_kp[page, rows_read[page]:] = nan_vp[page, rows_read[page]:] = float("nan")
    q = torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
    return ((q, nan_kp.to(dtype), nan_vp.to(dtype), nan_tables, valid),
            (q, kp.to(dtype), vp.to(dtype), tables, valid))


def check_aliased_pages(torch, kmod) -> None:
    """Kernel 2 against its plain version over block tables whose rows name
    the same pages (prefix sharing), fp32 and bf16, with every page and row
    no request may read filled with NaN."""
    for dname in ("float32", "bfloat16"):
        nan_inputs, inputs = aliased_page_inputs(torch, getattr(torch, dname))
        out = kmod.paged_decode_attention(*nan_inputs, scale=1.0 / 16)
        want = kmod.paged_decode_attention_ref(*inputs, scale=1.0 / 16)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        ok = bool(torch.isfinite(out).all()) and torch.allclose(out.float(), want.float(),
                                                                **TOL[dname])
        print(f"[kernels] paged_decode_attention over aliased tables (rows 0-4 share 3 "
              f"pages, rows 3-4 a 4th) {dname}: max_abs_err={err:.3e} tol={TOL[dname]} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"paged_decode_attention disagrees over aliased tables ({dname})")


def make_mla_inputs(torch, case, dtype, seed):
    """Seeded inputs of one MLA case, in the kernel's argument order."""
    _, paged, b, h, rank, rope, l, bs, _ = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    valid = _valid_lens(torch, g, b, l)
    q_lat = torch.randn((b, h, rank), generator=g, device=dev).to(dtype)
    q_rope = torch.randn((b, h, rope), generator=g, device=dev).to(dtype)
    rows = (1 + b * (l // bs), bs) if paged else (b, l)
    ckv = torch.randn(rows + (rank,), generator=g, device=dev).to(dtype)
    kr = torch.randn(rows + (rope,), generator=g, device=dev).to(dtype)
    if not paged:
        return (q_lat, q_rope, ckv, kr, valid)
    return (q_lat, q_rope, ckv, kr, _tables(torch, g, valid, bs, l // bs, rows[0]), valid)


def make_ssd_inputs(torch, shape, dtype, seed, groups=None):
    """Seeded SSD inputs (x, dt, a, b, c), scaled as tests/test_kernels.py's;
    with ``groups`` b and c are (B, S, G, N)."""
    b, s, h, p, n = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((b, s, h, p), generator=g, device="cuda") * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g, device="cuda"))
    a = -torch.exp(torch.linspace(-2, 0.5, h, device="cuda"))
    bc = (b, s, n) if groups is None else (b, s, groups, n)
    bm = (torch.randn(bc, generator=g, device="cuda") * 0.3).to(dtype)
    cm = (torch.randn(bc, generator=g, device="cuda") * 0.3).to(dtype)
    return (x, dt, a, bm, cm)


def make_gdn_inputs(torch, shape, dtype, seed):
    """Seeded GDN inputs (q, k, v, beta, alpha): unit-norm q and k, as the
    model's L2 norm makes them, gates as tests/test_kernels.py draws them."""
    b, s, h, k = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    unit = lambda t: t / t.norm(dim=-1, keepdim=True)
    q = unit(torch.randn((b, s, h, k), generator=g, device="cuda")).to(dtype)
    kk = unit(torch.randn((b, s, h, k), generator=g, device="cuda")).to(dtype)
    v = (torch.randn((b, s, h, k), generator=g, device="cuda") * 0.5).to(dtype)
    beta = torch.sigmoid(torch.randn((b, s, h), generator=g, device="cuda"))
    alpha = torch.sigmoid(torch.randn((b, s, h), generator=g, device="cuda") + 2)
    return (q, kk, v, beta, alpha)


def scan_bound(name, shape, elem):
    """(bound_ms, bound_by) of a scan call, by ``kernels.cost``: every input
    read once, y and the fp32 final state written once, against the chunked
    forms' operations at ``cost.SCAN_CHUNK``."""
    from repro_torch.kernels import cost

    return cost.bound_ms(getattr(cost, name)(*shape, elem))


def scan_bwd_bound(name, shape, elem):
    """(bound_ms, bound_by) of a backward scan call without dfinal, by
    ``kernels.cost``: inputs and gradients once, against three times the
    forward's operations."""
    from repro_torch.kernels import cost

    return cost.bound_ms(getattr(cost, name)(*shape, elem))


def make_scan_bwd_args(torch, name, shape, dtype, seed):
    """A backward case's (forward inputs..., dy) and dfinal: the forward's
    inputs as phase 3 draws them, cotangents from a seeded generator."""
    fwd = make_ssd_inputs if name == "ssd_scan_bwd" else make_gdn_inputs
    inputs = fwd(torch, shape, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    state = (shape[0], shape[2], shape[3], shape[4] if name == "ssd_scan_bwd" else shape[3])
    dy = (torch.randn(inputs[0].shape, generator=g, device="cuda") * 0.1).to(dtype)
    dfinal = torch.randn(state, generator=g, device="cuda") * 0.1
    return inputs + (dy,), dfinal


# the tensor-core kernels, by library: each must hold HMMA (mma.sync) or
# HGMMA (wgmma) instructions in its SASS
TENSOR_CORE_KERNELS = {"decode_attn": ("tc_split_kernel",),
                       "mla_decode": ("mla_tc_split_kernel",),
                       "ssd_scan": ("ssd_tc_kernel",),
                       "gdn_scan": ("gdn_prep_kernel", "gdn_chain_kernel"),
                       "ssd_scan_bwd": ("ssd_bwd_tc_kernel",),
                       "gdn_scan_bwd": ("gdn_bwd_prep_kernel", "gdn_bwd_chain_kernel",
                                        "gdn_bwd_post_kernel"),
                       "prefill_attn": ("prefill_attn_kernel",)}


def tensor_core_check(info) -> list:
    """For each tensor-core kernel, ``cuobjdump -sass`` of its library: the
    number of HMMA/HGMMA instructions in every function of that name. Raises
    if one has none, or if cuobjdump is not installed."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise SystemExit("cuobjdump not found: the tensor-core kernels' SASS cannot be checked")
    lines = []
    for lib, kernels in TENSOR_CORE_KERNELS.items():
        sass = subprocess.run([tool, "-sass", info[lib]["path"]], check=True,
                              capture_output=True, text=True).stdout
        for kernel in kernels:
            counts, fn = {}, None
            for line in sass.splitlines():
                if "Function :" in line:
                    fn = line.split("Function :")[1].strip()
                elif fn and kernel in fn and ("HMMA" in line or "HGMMA" in line):
                    counts[fn] = counts.get(fn, 0) + 1
            n_fns = sum(kernel in ln for ln in sass.splitlines() if "Function :" in ln)
            if not counts or len(counts) < n_fns:
                raise SystemExit(f"{lib}: a {kernel} instantiation has no tensor-core instruction")
            lines.append(f"{lib}: {kernel} x{n_fns} instantiations, HMMA/HGMMA per "
                         f"instantiation {sorted(counts.values())}")
    return lines


def bound(torch, case, inputs, elem):
    """(bound_ms, bound_by) of a GQA case by ``kernels.cost``: its keys are
    those below each row's valid_len (the last ``window`` of them under a
    window), its table entries those a paged call reads."""
    from repro_torch.kernels import cost

    paged, b, h, kv, dk, dv, l, bs = case[1:9]
    window = case.window
    valid = inputs[-1].clamp(max=l).to(torch.int64)
    first = (valid - window).clamp(min=0) if window else torch.zeros_like(valid)
    keys = int((valid - first).sum())
    if paged:
        pages = int(((valid + bs - 1) // bs - first // bs).sum())
        return cost.bound_ms(cost.paged_decode_attention(b, h, kv, dk, dv, elem, keys, pages))
    return cost.bound_ms(cost.decode_attention(b, h, kv, dk, dv, elem, keys))


def mla_bound(torch, case, inputs, elem):
    """(bound_ms, bound_by) of an MLA case by ``kernels.cost``: its keys are
    those below each row's valid_len, its table entries those a paged call
    reads."""
    from repro_torch.kernels import cost

    _, paged, b, h, rank, rope, l, bs, _ = case
    valid = inputs[-1].clamp(max=l).to(torch.int64)
    keys = int(valid.sum())
    if paged:
        pages = int(((valid + bs - 1) // bs).sum())
        return cost.bound_ms(cost.mla_paged_latent_decode(b, h, rank, rope, elem, keys, pages))
    return cost.bound_ms(cost.mla_latent_decode(b, h, rank, rope, elem, keys))


def gqa_sdpa(torch, F, l, scale):
    """One ``F.scaled_dot_product_attention`` call computing the dense GQA
    kernel's function (yardstick only)."""
    kpos = torch.arange(l, device="cuda")

    def sdpa(q, k, v, valid):
        mask = (kpos[None, :] < valid[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, scale=scale, enable_gqa=True)

    return sdpa


def mla_sdpa(torch, F, l, scale):
    """One ``F.scaled_dot_product_attention`` call computing the dense MLA
    kernel's function (yardstick only): MQA of ``[q_lat; q_rope]`` over one
    head ``[ckv; kr]`` with V = ``ckv``. Both concatenations are made once
    per input set, OUTSIDE the timed call, which therefore times the
    attention alone."""
    kpos = torch.arange(l, device="cuda")

    def prepare(q_lat, q_rope, ckv, kr, valid):
        return (torch.cat([q_lat, q_rope], -1)[:, :, None],
                torch.cat([ckv, kr], -1)[:, None], ckv[:, None], valid)

    def sdpa(q_cat, k_cat, v, valid):
        mask = (kpos[None, :] < valid[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(q_cat, k_cat, v, attn_mask=mask, scale=scale,
                                              enable_gqa=True)

    return prepare, sdpa


def check_kernels(torch, F, kmod):
    """Phase 3: every case in fp32 and bf16 against the plain version, every
    output finite; time the main-path cases and ``TIMED_EXTRA``. Returns
    {kernel name: record of its main case}."""
    records = {}
    cases = ([(c, make_inputs, bound) for c in KERNEL_CASES]
             + [(c, make_mla_inputs, mla_bound) for c in MLA_CASES])
    for case, make, bound_fn in cases:
        name, paged, main, l = case.name, case.paged, case.main, case.l
        kernel = getattr(kmod, name)
        plain = getattr(kmod, name + "_ref")
        kw = case_kwargs(case)
        label = case_label(case)
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            inputs = make(torch, case, dtype, seed=case_seed(case))
            out = kernel(*inputs, **kw)
            want = plain(*inputs, **kw)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            ok = bool(torch.isfinite(out).all()) and torch.allclose(out.float(), want.float(),
                                                                    **TOL[dname])
            print(f"[kernels] {name} {label} {dname}: max_abs_err={err:.3e} tol={TOL[dname]} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"{name} {label} disagrees with its plain version ({dname})")
            if case in TIMED_EXTRA and (dname == "bfloat16" or case in FOLDED):
                sets = cold_sets(inputs)
                ms = cuda_time_ms(torch, lambda *a: kernel(*a, **kw), sets)[0]
                plain_ms = cuda_time_ms(torch, lambda *a: plain(*a, **kw), sets)[0]
                bound_ms, bound_by = bound_fn(torch, case, inputs, out.element_size())
                sdpa = ("" if paged or case.softcap or case.window else ", sdpa %.5f" % (
                    cuda_time_ms(torch, gqa_sdpa(torch, F, l, kw["scale"]), sets)[0]))
                valid = inputs[-1].tolist()
                print(f"[kernels] {name} {label} {dname} (not a main case), device ms (CUDA "
                      f"graph): kernel {ms:.5f}, plain {plain_ms:.5f}{sdpa}, bound "
                      f"{bound_ms:.5f} ({bound_by}); valid_len={valid[:16]}"
                      + (f" ... ({len(valid)} rows, {sum(valid)} keys)" if len(valid) > 16
                         else ""))
                del sets
            if not (main and dname == "bfloat16"):
                continue
            elem = out.element_size()
            scale = kw["scale"]
            sets = cold_sets(inputs)
            ms, ms_eager = cuda_time_ms(torch, lambda *a: kernel(*a, **kw), sets)
            plain_ms, plain_eager = cuda_time_ms(torch, lambda *a: plain(*a, **kw), sets)
            library_ms = lib_eager = None
            if not paged and isinstance(case, Mla):
                prepare, sdpa = mla_sdpa(torch, F, l, scale)
                lib_sets = [prepare(*a) for a in sets]
                library_ms, lib_eager = cuda_time_ms(torch, sdpa, lib_sets)
                del lib_sets
            elif not paged:
                library_ms, lib_eager = cuda_time_ms(torch, gqa_sdpa(torch, F, l, scale), sets)
            bound_ms, bound_by = bound_fn(torch, case, inputs, elem)
            source, replaces = SOURCES[name]
            records[name] = {
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            }
            print(f"[kernels] {name} main shape bf16, device ms (CUDA graph): kernel {ms:.5f}, "
                  f"plain {plain_ms:.5f}, sdpa {library_ms}, bound {bound_ms:.5f} ({bound_by}); "
                  f"eager ms per call: kernel {ms_eager:.5f}, plain {plain_eager:.5f}, "
                  f"sdpa {lib_eager}; valid_len={inputs[-1].tolist()}")
            del sets
    return records


# kernels 1 and 4 with their log-sum-exp output (return_lse), held against
# their plain twins: the main cases, then the rows of a shard of a cache
# split over ranks -- valid_len 0 (no key here: output 0, lse -inf), past L
# (the keys run on into the next shard), and under a window whose first key
# lies past L (none here either)
LSE_SHARD_VALID = (0, 300, 129, 700, 17, 256, 1000, 64)
LSE_SHARD_L, LSE_SHARD_WINDOW = 256, 200


def _lse_agree(torch, got, want, tol) -> tuple:
    """(max |err| over finite entries, the same entries infinite)."""
    same_inf = bool(torch.equal(torch.isinf(got), torch.isinf(want)))
    fin = torch.isfinite(want)
    err = (got[fin].float() - want[fin].float()).abs().max().item() if fin.any() else 0.0
    return err, same_inf and torch.allclose(got[fin].float(), want[fin].float(), **tol)


def check_lse(torch, kmod) -> None:
    """Phase 3: kernels 1 and 4's ``return_lse`` outputs (out and lse)
    against their twins, fp32 and bf16, at the main cases and at a shard's
    rows (``LSE_SHARD_VALID``)."""
    main = {"decode_attention": next(c for c in KERNEL_CASES if c.main and not c.paged),
            "mla_latent_decode": next(c for c in MLA_CASES if c.main and not c.paged)}
    for name, case in main.items():
        kernel, plain = getattr(kmod, name), getattr(kmod, name + "_ref")
        make = make_inputs if name == "decode_attention" else make_mla_inputs
        kw = case_kwargs(case)
        for shard in (False, True):
            for dname in ("float32", "bfloat16"):
                dtype = getattr(torch, dname)
                inputs = list(make(torch, case, dtype, seed=case_seed(case)))
                extra = {}
                if shard:      # the first L_SHARD keys, the shard's valid lengths
                    inputs = [t[:, :LSE_SHARD_L].contiguous()
                              if t.dim() > 2 and t.shape[1] == case.l else t for t in inputs]
                    inputs[-1] = torch.tensor(LSE_SHARD_VALID, dtype=torch.int32,
                                              device="cuda")[:case.b]
                    if name == "decode_attention":
                        extra = {"window": LSE_SHARD_WINDOW}
                out, lse = kernel(*inputs, **kw, **extra, return_lse=True)
                want, want_lse = plain(*inputs, **kw, **extra, return_lse=True)
                torch.cuda.synchronize()
                err = (out.float() - want.float()).abs().max().item()
                lse_err, lse_ok = _lse_agree(torch, lse, want_lse, TOL[dname])
                ok = (lse_ok and bool(torch.isfinite(out).all())
                      and torch.allclose(out.float(), want.float(), **TOL[dname]))
                rows = "shard rows valid_len=%s%s" % (
                    inputs[-1].tolist(), f" window {LSE_SHARD_WINDOW}" if extra else "") \
                    if shard else "main case"
                print(f"[kernels] {name} return_lse {rows} {dname}: out max_abs_err={err:.3e}, "
                      f"lse max_abs_err={lse_err:.3e} (-inf rows "
                      f"{int(torch.isinf(lse).sum())}) tol={TOL[dname]} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"{name} return_lse disagrees with its twin ({dname})")


def check_scan_kernels(torch, kmod, records) -> None:
    """Phase 3 for the prefill scans: every case in fp32 and bf16 through
    ``ssd_prefill`` / ``gdn_prefill`` (the kernel, after padding to its chunk
    where S is not a multiple) against the plain version on the unpadded
    inputs, y and the final state; time the main case. Adds a record per
    kernel to ``records``."""
    specs = (("ssd_scan", SSD_CASES, make_ssd_inputs, kmod.ssd_prefill, kmod.ssd_scan_ref,
              ("B", "S", "H", "P", "N")),
             ("gdn_scan", GDN_CASES, make_gdn_inputs, kmod.gdn_prefill, kmod.gdn_scan_ref,
              ("B", "S", "H", "K")))
    for name, cases, make, prefill_fn, plain, dims in specs:
        for case in cases:
            shape, main = case[:-1], case[-1]
            label = " ".join(f"{k}={v}" for k, v in zip(dims, shape))
            for dname in ("float32", "bfloat16"):
                dtype = getattr(torch, dname)
                inputs = make(torch, shape, dtype, seed=case_seed((name, *case)))
                y, fs = prefill_fn(*inputs)
                want_y, want_fs = plain(*inputs)
                torch.cuda.synchronize()
                err = max((y.float() - want_y).abs().max().item(),
                          (fs - want_fs).abs().max().item())
                ok = (y.dtype == dtype and tuple(y.shape) == tuple(want_y.shape)
                      and torch.allclose(y.float(), want_y, **SCAN_TOL[dname])
                      and torch.allclose(fs, want_fs, **SCAN_TOL[dname]))
                print(f"[kernels] {name} {label} {dname}: max_abs_err={err:.3e} (y and final "
                      f"state, max |y| {want_y.abs().max().item():.3f}) tol={SCAN_TOL[dname]} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"{name} disagrees with its plain version ({dname})")
                if not (main and dname == SCAN_TIMED_DTYPE[name]):
                    continue
                kernel = getattr(kmod, name)
                sets = cold_sets(inputs)
                ms, ms_eager = cuda_time_ms(torch, kernel, sets)
                plain_ms, plain_eager = cuda_time_ms(torch, plain, sets, reps=PLAIN_SCAN_REPS)
                bound_ms, bound_by = scan_bound(name, shape, inputs[0].element_size())
                source, replaces = SOURCES[name]
                records[name] = {
                    "name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                }
                print(f"[kernels] {name} main shape {dname}, device ms (CUDA graph): kernel "
                      f"{ms:.5f}, plain {plain_ms:.5f}, bound {bound_ms:.5f} ({bound_by}), "
                      f"library null ({SCAN_NO_LIBRARY}); eager ms per call: kernel "
                      f"{ms_eager:.5f}, plain {plain_eager:.5f}")
                del sets


# the causal prefill-attention kernel: (arch, B, S, H, KV, D, softcap,
# window, main), bf16; the main case is minitron-4b's 4096 bucket (the
# prefill cell's p95), then its 2048 bucket, gemma2-9b's local layers
# (softcap 50, window 4096) over a prompt in the 8192 bucket, gemma-2b
# (MQA, D 256) and minicpm-2b (G 1, D 64) at the 4096 bucket, and a batched
# admission (B 3) off the 64-key tile
PrefillAttn = collections.namedtuple("PrefillAttn", "arch b s h kv d softcap window main")
PREFILL_ATTN_CASES = (
    PrefillAttn("minitron-4b", 1, 4096, 24, 8, 128, 0.0, 0, True),
    PrefillAttn("minitron-4b", 1, 2048, 24, 8, 128, 0.0, 0, False),
    PrefillAttn("gemma2-9b", 1, 8192, 16, 8, 256, 50.0, 4096, False),
    PrefillAttn("gemma-2b", 1, 4096, 8, 1, 256, 0.0, 0, False),
    PrefillAttn("minicpm-2b", 1, 4096, 36, 36, 64, 0.0, 0, False),
    PrefillAttn("minitron-4b", 3, 333, 24, 8, 128, 0.0, 0, False),
)
PLAIN_ATTN_REPS = 3      # the plain path holds (S, S) fp32 scores a head


def prefill_attn_case(torch, case) -> tuple:
    """(dtype name, (q, k, v) bf16 on the card, keyword arguments) of a
    PREFILL_ATTN_CASES case."""
    g = torch.Generator(device="cuda").manual_seed(case_seed(case))
    inputs = tuple(torch.randn(shape, generator=g, device="cuda").bfloat16()
                   for shape in ((case.b, case.s, case.h, case.d),
                                 (case.b, case.s, case.kv, case.d),
                                 (case.b, case.s, case.kv, case.d)))
    kw = {"scale": 1.0 / math.sqrt(case.d), "softcap": case.softcap, "window": case.window}
    return "bfloat16", inputs, kw


def check_prefill_attention(torch, F, kmod, records) -> None:
    """Phase 3 for ``prefill_attention``: each PREFILL_ATTN_CASES case in
    bf16 launched once and held against its plain twin (TOL, both outputs
    bf16) and reported beside the model's plain path
    (``attention_prefill(plain=True)``), every output finite; then each
    case's device ms: the kernel, its bound (``kernels.cost``), the plain
    path, and as the yardstick ``F.scaled_dot_product_attention(is_causal=
    True)`` (no softcap or window: null for gemma2-9b's case)."""
    from repro_torch.kernels import cost
    from repro_torch.models.attention import attention_prefill

    name = "prefill_attention"
    kernel, twin = kmod.prefill_attention, kmod.prefill_attention_ref
    for case in PREFILL_ATTN_CASES:
        b, s, h, kv, d = case.b, case.s, case.h, case.kv, case.d
        _, inputs, kw = prefill_attn_case(torch, case)
        label = f"{case.arch} B={b} S={s} H={h} KV={kv} D={d} softcap={case.softcap} " \
                f"window={case.window}"
        with torch.inference_mode():
            n0 = kernel.launches
            out = kernel(*inputs, **kw)
            launched = kernel.launches - n0
            want = twin(*inputs, kw["scale"], softcap=case.softcap, window=case.window)
            plain = attention_prefill(*inputs, plain=True, **kw)
            torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        err_plain = (out.float() - plain.float()).abs().max().item()
        ok = (launched == 1 and bool(torch.isfinite(out.float()).all())
              and torch.allclose(out.float(), want.float(), **TOL["bfloat16"]))
        print(f"[kernels] {name} {label} bfloat16: max_abs_err={err:.3e} (twin), "
              f"{err_plain:.3e} (plain path) tol={TOL['bfloat16']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name} {label} disagrees with its plain twin")
        del out, want, plain
        sets = cold_sets(inputs)
        ms, ms_eager = cuda_time_ms(torch, lambda *a: kernel(*a, **kw), sets)
        plain_ms, _ = cuda_time_ms(torch, lambda *a: attention_prefill(*a, plain=True, **kw),
                                   sets[:1], reps=PLAIN_ATTN_REPS)
        library_ms = None
        if not (case.softcap or case.window):
            sdpa = lambda q, k, v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                scale=kw["scale"], enable_gqa=True)
            library_ms = cuda_time_ms(torch, sdpa, sets)[0]
        bound_ms, bound_by = cost.bound_ms(cost.prefill_attention(
            b, s, s, h, kv, d, d, 2, case.window))
        print(f"[kernels] {name} {label} bfloat16, device ms (CUDA graph): kernel {ms:.5f} "
              f"({ms / bound_ms:.2f}x the bound), plain {plain_ms:.5f}, sdpa {library_ms}, "
              f"bound {bound_ms:.5f} ({bound_by}); eager ms per call: kernel {ms_eager:.5f}")
        if case.main:
            source, replaces = SOURCES[name]
            records[name] = {
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            }
        del sets, inputs
        torch.cuda.empty_cache()


def check_ssd_groups(torch, kmod) -> None:
    """Phase 3 for ``ssm_groups > 1``: kernel 3 (``ssd_scan``) and its
    backward (``ssd_scan_bwd``) at ``SSD_GROUP_SHAPE`` with G in
    ``SSD_GROUPS`` groups of B/C, in fp32 and bf16, each launched once (a
    count of the wrapper's launches: no plain fallback) and held against its
    plain version (y and the final state at SCAN_TOL; every gradient, db and
    dc per group, at SCAN_BWD_RTOL of its largest entry); then, in bf16, the
    device ms of G = 1 and each G in one call, beside each one's bound from
    ``kernels.cost`` with its G."""
    from repro_torch.kernels import cost

    timed = {}
    for groups in SSD_GROUPS:
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            seed = case_seed(("ssd_groups", groups, dname))
            inputs = make_ssd_inputs(torch, SSD_GROUP_SHAPE, dtype, seed, groups=groups)
            before = kmod.ssd_scan.launches
            y, fs = kmod.ssd_scan(*inputs)
            launched = kmod.ssd_scan.launches - before
            want_y, want_fs = kmod.ssd_scan_ref(*inputs)
            torch.cuda.synchronize()
            err = max((y.float() - want_y).abs().max().item(), (fs - want_fs).abs().max().item())
            ok = (launched == 1 and torch.allclose(y.float(), want_y, **SCAN_TOL[dname])
                  and torch.allclose(fs, want_fs, **SCAN_TOL[dname]))
            print(f"[groups] ssd_scan G={groups} {dname}: launches {launched}, max_abs_err="
                  f"{err:.3e} tol={SCAN_TOL[dname]} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"ssd_scan with {groups} groups disagrees with its plain "
                                 f"version ({dname})")
            gen = torch.Generator(device="cuda").manual_seed(seed + 1)
            dy = (torch.randn(inputs[0].shape, generator=gen, device="cuda") * 0.1).to(dtype)
            before = kmod.ssd_scan_bwd.launches
            got = kmod.ssd_scan_bwd(*inputs, dy, None)
            launched = kmod.ssd_scan_bwd.launches - before
            want = kmod.ssd_scan_bwd_ref(*inputs, dy, None)
            torch.cuda.synchronize()
            rel = {f"d{n}": ((g.float() - w).abs().max() / w.abs().max()).item()
                   for n, g, w in zip(("x", "dt", "a", "b", "c"), got, want)}
            ok = (launched == 1 and all(r <= SCAN_BWD_RTOL[dname] for r in rel.values())
                  and [g.shape for g in got] == [t.shape for t in inputs])
            print(f"[groups] ssd_scan_bwd G={groups} {dname}: launches {launched}, max |diff| / "
                  f"max |twin| {json.dumps({k: float(f'{v:.3e}') for k, v in rel.items()})} "
                  f"rtol {SCAN_BWD_RTOL[dname]} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"ssd_scan_bwd with {groups} groups disagrees with its twin "
                                 f"({dname})")
            del got, want, y, fs, want_y, want_fs
    for groups in (1,) + SSD_GROUPS:
        inputs = make_ssd_inputs(torch, SSD_GROUP_SHAPE, torch.bfloat16, seed=7,
                                 groups=None if groups == 1 else groups)
        dy = (inputs[0].float() * 0.1).to(torch.bfloat16)
        sets = cold_sets(inputs + (dy,))
        fwd, _ = cuda_time_ms(torch, lambda *t: kmod.ssd_scan(*t[:5]), sets)
        bwd, _ = cuda_time_ms(torch, lambda *t: kmod.ssd_scan_bwd(*t, None), sets, reps=10)
        timed[groups] = {
            "ssd_scan_ms": fwd,
            "ssd_scan_bound_ms": cost.bound_ms(cost.ssd_scan(*SSD_GROUP_SHAPE, 2, g=groups))[0],
            "ssd_scan_bwd_ms": bwd,
            "ssd_scan_bwd_bound_ms": cost.bound_ms(
                cost.ssd_scan_bwd(*SSD_GROUP_SHAPE, 2, g=groups))[0]}
        del sets
    print("[groups] bf16 device ms (CUDA graph) by G at B S H P N = "
          f"{SSD_GROUP_SHAPE}: " + json.dumps(timed))
    torch.cuda.empty_cache()


def check_prng(torch) -> None:
    """The sampling bits on the card: ``serving.prng.uniform`` for keys of
    ``PRNG_SEEDS`` (and keys split from them) on the device equal the CPU's
    bit for bit, and one ``PRNG_DRAW`` draw's device time."""
    from repro_torch.serving import prng

    keys = [k for seed in PRNG_SEEDS
            for k in (prng.PRNGKey(seed), prng.split(prng.PRNGKey(seed))[1])]
    for key in keys:
        on_card = prng.uniform(key, (3, 1027), device="cuda").cpu()
        on_host = prng.uniform(key, (3, 1027), device="cpu")
        if not torch.equal(on_card.view(torch.int32), on_host.view(torch.int32)):
            raise SystemExit(f"prng: the device uniform of key {key.tolist()} differs from the "
                             f"CPU's")
    big = prng.uniform(keys[1], PRNG_DRAW, device="cuda")
    if not torch.equal(big.cpu().view(torch.int32),
                       prng.uniform(keys[1], PRNG_DRAW, device="cpu").view(torch.int32)):
        raise SystemExit(f"prng: a {PRNG_DRAW} device draw differs from the CPU's")
    ms, eager = cuda_time_ms(torch, lambda k: prng.uniform(k, PRNG_DRAW, device="cuda"),
                             [(keys[1],)], reps=10)
    # the pool's sampling on the card against the CPU, on near-flat logits
    # where the draw decides: the same tokens, and the sampled slots off the argmax
    import numpy as np

    from repro_torch.serving.pool import Pool

    pool = Pool.__new__(Pool)
    gen = torch.Generator(device="cuda").manual_seed(3)
    logits = torch.randn(PRNG_DRAW, generator=gen, device="cuda") * 0.1
    temps = np.array([SAMPLED_TEMPERATURE if i % 2 == 0 else 0.0 for i in range(PRNG_DRAW[0])],
                     np.float32)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    pool.device = logits.device
    on_card = pool._sample(logits, greedy, temps, keys[1]).cpu()
    pool.device = torch.device("cpu")
    on_host = pool._sample(logits.cpu(), greedy.cpu(), temps, keys[1])
    moved = int((on_card != greedy.cpu()).sum())
    if not torch.equal(on_card, on_host) or moved == 0:
        raise SystemExit(f"prng: sampled tokens on the card {on_card.tolist()} against the "
                         f"CPU's {on_host.tolist()} (greedy {greedy.tolist()})")
    print(f"[prng] device uniform == CPU uniform bit for bit over {len(keys)} keys and one "
          f"{PRNG_DRAW} draw: ok; Pool._sample on the card == on the CPU ({moved} of "
          f"{PRNG_DRAW[0] // 2} sampled slots off the argmax); one {PRNG_DRAW} draw "
          f"{ms * 1e3:.1f} us device (CUDA graph), {eager * 1e3:.1f} us eager")


def sampled_runs(torch, kmod, cfg, params, prompts, greedy) -> None:
    """Phase 4's sampled gemma-2b runs: the same prompts with every third at
    ``SAMPLED_TEMPERATURE`` (the key split as the reference splits it, the
    uniform drawn on the card), dense, with the decode step replayed from a
    CUDA graph and eager: the two sampled streams must be equal, since a
    graph step's logits are eager's. Prints how many tokens of the sampled
    requests part from ``greedy`` (the greedy graph run's streams)."""
    temps = [SAMPLED_TEMPERATURE if i % 3 == 0 else 0.0 for i in range(len(prompts))]
    streams, runs = {}, {}
    for graphs in (True, False):
        mode = "graph" if graphs else "eager"
        engine, reqs, info = serve(torch, cfg, params, prompts, paged=False, max_new=32,
                                   kmod=kmod, graphs=graphs, temps=temps)
        check_launches(cfg.name, f"dense {mode} sampled", False, cfg, engine.stats, info)
        streams[mode] = [r.output for r in reqs]
        steps = info["step_ms_batch8"]
        runs[mode] = {"decode_steps": engine.stats.decode_steps,
                      "graph_replays": info["graph_replays"],
                      "decode_step_ms_batch8_mean": sum(steps) / len(steps) if steps else None}
        del engine
    if streams["graph"] != streams["eager"]:
        raise SystemExit(f"{cfg.name}: sampled streams differ between graph and eager")
    parted = sum(a != b for i, (s, g) in enumerate(zip(streams["graph"], greedy)) if temps[i]
                 for a, b in zip(s, g))
    print(f"[serve] {cfg.name} dense bf16 sampled (every third request at "
          f"{SAMPLED_TEMPERATURE}): " + json.dumps(runs) + ", graph and eager streams equal; "
          f"{parted} tokens of the sampled requests part from the greedy run's")


def check_scan_bwd_kernels(torch, kmod, records) -> None:
    """Phase 3 for the scans' backward kernels: every case in fp32 and bf16,
    with dfinal absent and present, against the twin (``*_scan_bwd_ref``)
    on the same inputs, each gradient within SCAN_BWD_RTOL of its largest
    entry and in its input's dtype, and two calls bitwise equal; S off the
    chunk through the prefill wrapper (padding, the autograd Function,
    autograd's slice) against the twin on the unpadded inputs. Times the
    main case without dfinal (the training path passes none) beside the
    twin and the bound. Adds a record per kernel to ``records``."""
    specs = (("ssd_scan_bwd", SSD_BWD_CASES, kmod.ssd_prefill, kmod.ssd_scan_bwd_ref,
              kmod.ssd_scan_bwd, ("x", "dt", "a", "b", "c"), ("B", "S", "H", "P", "N")),
             ("gdn_scan_bwd", GDN_BWD_CASES, kmod.gdn_prefill, kmod.gdn_scan_bwd_ref,
              kmod.gdn_scan_bwd, ("q", "k", "v", "beta", "alpha"), ("B", "S", "H", "K")))
    for name, cases, prefill_fn, twin, kernel, names, dims in specs:
        chunk = kmod.ssd.ssd.CHUNK if name == "ssd_scan_bwd" else kmod.gdn.gdn.CHUNK
        for case in cases:
            shape, main = case[:-1], case[-1]
            label = " ".join(f"{k}={v}" for k, v in zip(dims, shape))
            for dname in ("float32", "bfloat16"):
                dtype = getattr(torch, dname)
                args, dfinal = make_scan_bwd_args(torch, name, shape, dtype,
                                                  seed=case_seed((name, *case)))
                for df in (None, dfinal):
                    if shape[1] % chunk:
                        def run():
                            leaves = [t.detach().requires_grad_() for t in args[:-1]]
                            y, fs = prefill_fn(*leaves)
                            outs, cots = ((y,), (args[-1],)) if df is None else \
                                ((y, fs), (args[-1], df))
                            return torch.autograd.grad(outs, leaves, cots)
                        route = "ssd_prefill" if name == "ssd_scan_bwd" else "gdn_prefill"
                    else:
                        run = lambda: kernel(*args, df)
                        route = name
                    got = run()
                    again = run()
                    want = twin(*args, df)
                    torch.cuda.synchronize()
                    rel = {f"d{n}": ((g.float() - w).abs().max() / w.abs().max()).item()
                           for n, g, w in zip(names, got, want)}
                    err = max((g.float() - w).abs().max().item() for g, w in zip(got, want))
                    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
                    ok = (bitwise and all(r <= SCAN_BWD_RTOL[dname] for r in rel.values())
                          and [g.dtype for g in got] == [t.dtype for t in args[:-1]])
                    print(f"[kernels] {name} {label} {dname} via {route}, dfinal "
                          f"{'present' if df is not None else 'absent'}: max |diff| / max "
                          f"|twin| {json.dumps({k: float(f'{v:.3e}') for k, v in rel.items()})}"
                          f", max_abs_err={err:.3e}, bitwise equal twice {bitwise}, rtol "
                          f"{SCAN_BWD_RTOL[dname]} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise SystemExit(f"{name} disagrees with its twin ({dname}, {label})")
                    del got, again, want
                if not (main and dname == SCAN_BWD_TIMED_DTYPE[name]):
                    continue
                sets = cold_sets(args)
                ms, ms_eager = cuda_time_ms(torch, kernel, sets, reps=10)
                plain_ms, plain_eager = cuda_time_ms(torch, twin, sets, reps=PLAIN_SCAN_REPS)
                bound_ms, bound_by = scan_bwd_bound(name, shape, args[0].element_size())
                source, replaces = SOURCES[name]
                records[name] = {
                    "name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                }
                print(f"[kernels] {name} main shape {dname}, device ms (CUDA graph): kernel "
                      f"{ms:.5f}, twin {plain_ms:.5f}, bound {bound_ms:.5f} ({bound_by}), "
                      f"library null ({SCAN_BWD_NO_LIBRARY}); eager ms per call: kernel "
                      f"{ms_eager:.5f}, twin {plain_eager:.5f}")
                # where a call's device time goes, by the kernels it launches
                rows, _, _, _ = profiled(
                    torch, lambda: [kernel(*sets[i % len(sets)], None) for i in range(3)], 3)
                print(f"[kernels] {name} main shape {dname}, profiled device ms a call by kernel: "
                      + json.dumps({k[:60]: round(ms_, 5) for ms_, _, k in rows}))
                del sets
                torch.cuda.empty_cache()


def expected_launches(arch, paged, cfg, stats, *, decode_steps=None, prefill_calls=None,
                      suffix_prefills=0) -> dict:
    """Each counted kernel's launches in one serving run of ``arch``: its
    decode kernel once per attention layer and decode step, its prefill
    scan once per recurrent layer and prefill call, ``prefill_attention``
    once per self-attention layer the kernel takes and prefill call but
    the ``suffix_prefills`` (prefix hits: the suffix prefill attends in
    plain PyTorch) (``stats``' counts, unless ``decode_steps`` /
    ``prefill_calls`` give the steps and calls that ran the model)."""
    want = dict.fromkeys(COUNTED, 0)
    kernels = KERNELS_OF[arch]
    steps = stats.decode_steps if decode_steps is None else decode_steps
    calls = stats.prefill_calls if prefill_calls is None else prefill_calls
    if kernels["decode"]:
        want[kernels["decode"][paged]] = _n_layers(cfg, "decode") * steps
    for name in kernels["prefill"]:
        if name == "prefill_attention":
            want[name] = _n_layers(cfg, "prefill_attn") * (calls - suffix_prefills)
        else:
            want[name] = _n_layers(cfg, "scan") * calls
    return want


def serve(torch, cfg, params, prompts, *, paged, max_new, kmod, graphs=True, profile=False,
          temps=None):
    """One engine run over ``prompts`` through ``ServingEngine.step``, its
    decode step replayed from a CUDA graph (``graphs``) or eager; returns
    (engine, requests, info). Every kernel's launch count is set to 0 just
    before the run and read just after it: a wrapper counts the launches
    made from Python (the eager steps and prefills), and a graph's replays
    launch what its capture recorded, so a kernel's launches in the run
    are its count plus replays x captured launches. With ``profile``, five
    full-batch decode steps run under ``torch.profiler`` (and are left out
    of the step times) to split their wall time into device busy and idle;
    with a graph, five more time each replay with CUDA events. ``temps``
    gives each prompt's sampling temperature (default all greedy)."""
    from repro_torch.core.energy import EnergyModel
    from repro_torch.hw.chips import H200_SXM
    from repro_torch.serving import ClockController, ServingEngine

    controller = ClockController(EnergyModel(H200_SXM), cfg, mode="lock")
    engine = ServingEngine(cfg, params, max_batch=8, max_seq_len=1024, controller=controller,
                           paged=paged, kv_block_size=16, device="cuda", cuda_graphs=graphs)
    temps = temps or [0.0] * len(prompts)
    reqs = [engine.submit(p, max_new_tokens=max_new, temperature=t)
            for p, t in zip(prompts, temps)]
    step_ms, prof_info, replay_info = [], None, None
    n_full = 0
    torch.cuda.synchronize()
    for name in COUNTED:
        getattr(kmod, name).launches = 0
    with SmiSampler() as smi:
        while engine.waiting or engine.pool.occupancy() > 0:
            full = engine.pool.occupancy() == 8 and not engine.waiting
            steady = engine.pool._decode_steps_run >= 2     # past the warm-up and capture
            n_full += full
            if profile and full and n_full == 10:
                prof_info = profile_steps(torch, engine, 5)
                if graphs:
                    replay_info = time_replays(torch, engine, 5)
                continue
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            if full and steady:
                step_ms.append((time.perf_counter() - t0) * 1e3)
    pool = engine.pool
    counts = {name: getattr(kmod, name).launches for name in COUNTED}
    info = {
        "launches": {name: counts[name] + pool.graph_replays * pool.captured_launches.get(name, 0)
                     for name in COUNTED},
        "counted": counts,
        "graph_replays": pool.graph_replays,
        "captured_launches": {k: n for k, n in pool.captured_launches.items() if n},
        "capture_ms": pool.graph_capture_ms,
        "decode_steps": engine.stats.decode_steps,
        "prefill_calls": engine.stats.prefill_calls,
        "step_ms_batch8": step_ms,
        "smi": smi.summary(),
        "profile": prof_info,
        "replays_timed": replay_info,
    }
    if graphs and pool.graph_replays != engine.stats.decode_steps - 1:
        raise SystemExit(f"{cfg.name}: {pool.graph_replays} graph replays in "
                         f"{engine.stats.decode_steps} decode steps (one eager step expected)")
    return engine, reqs, info


def time_replays(torch, engine, n: int) -> dict:
    """``n`` engine steps whose graph replays are each timed with CUDA
    events on the stream (the graph's device time, gaps between its kernels
    included), beside the host-clock wall of each step: the step's idle
    share without the profiler's overhead."""
    graph = engine.pool._graph
    real, events = graph.replay, []

    def timed_replay():
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        real()
        ev[1].record()
        events.append(ev)

    graph.replay = timed_replay
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    finally:
        del graph.replay
    replay = sum(a.elapsed_time(b) for a, b in events) / len(events)
    return {"wall_ms_per_step": wall, "replay_device_ms": replay,
            "device_idle_share": 1.0 - replay / wall, "replays": len(events)}


def _device_rows(prof, n: int) -> list:
    """(device ms, calls, name) per device kernel of a profile, divided by
    ``n`` (steps), largest first."""
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0 and getattr(e, "device_type", None) is not None and \
                "CUDA" in str(e.device_type):
            rows.append((dev / 1e3 / n, e.count / n, e.key))
    rows.sort(reverse=True)
    return rows


PROFILE_ATTEMPTS = 3
PROFILE_ROWS = 20        # kernels listed a profiled decode step, largest first
STEP_GAP_US = 100.0      # a device gap longer than this lies between steps


def _device_timeline(prof, n: int) -> dict:
    """The profile's device timeline per step (``n`` steps): the union of
    the device events' intervals (kernels that overlap, as a combine
    launched with programmatic dependent launch overlaps its split kernel,
    count once), and the idle gaps between them, split at STEP_GAP_US into
    gaps inside a step's run of kernels and gaps between steps."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if "CUDA" in str(getattr(e, "device_type", "")))
    busy = inside = between = 0.0
    end = spans[0][0] if spans else 0.0
    for a, b in spans:
        if a > end:
            if a - end > STEP_GAP_US:
                between += a - end
            else:
                inside += a - end
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return {"union_busy_ms_per_step": busy / 1e3 / n, "gaps_inside_ms_per_step": inside / 1e3 / n,
            "gaps_between_ms_per_step": between / 1e3 / n}


def profiled(torch, run, n: int) -> tuple:
    """``run()`` under torch.profiler, the card idle before it: (device rows
    of ``_device_rows(prof, n)``, wall ms per ``n``, attempts,
    ``_device_timeline(prof, n)``). A profile
    that caught no device event at all is taken again, up to
    PROFILE_ATTEMPTS times: the profiler has once recorded no device event
    for a prefill whose kernels ran, and the attempts say if it did again."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        rows = _device_rows(prof, n)
        if rows:
            break
        print(f"[profile] attempt {attempt}: no device event recorded", file=sys.stderr)
    return rows, wall, attempt, _device_timeline(prof, n)


def profile_steps(torch, engine, n: int) -> dict:
    """``n`` engine steps under torch.profiler: wall ms per step, device busy
    ms per step (sum of kernel self time), the top kernels by device time."""
    def run():
        for _ in range(n):
            engine.step()

    rows, wall, attempts, timeline = profiled(torch, run, n)
    busy = sum(r[0] for r in rows)
    return {"wall_ms_per_step": wall, "device_busy_ms_per_step": busy, "attempts": attempts,
            "device_idle_share": 1.0 - busy / wall if wall else None,
            **timeline,
            "union_idle_share": 1.0 - timeline["union_busy_ms_per_step"] / wall,
            "kernels_per_step": sum(r[1] for r in rows),
            "top": [{"kernel": k[:90], "ms_per_step": ms, "calls_per_step": c}
                    for ms, c, k in rows[:PROFILE_ROWS]]}


def _padded(torch, pool, prompt):
    """(tokens (1, bucket), prompt_lengths (1,)) on the card, padded with
    token 0 to the pool's bucket exactly as the pool pads a prefill."""
    from repro_torch.serving.pool import Request

    toks, true_len, _ = pool.prefill_tokens(Request(uid=0, prompt=prompt))
    return torch.from_numpy(toks).cuda(), torch.from_numpy(true_len).cuda()


def profile_prefill(torch, cfg, params, prompt) -> dict:
    """One batch-1 prefill of ``prompt`` (padded to its bucket, as the pool
    runs it) under torch.profiler, after one unprofiled warm-up: wall ms,
    device busy ms (sum of kernel self time), the top kernels by device
    time. Launch counts are not read here."""
    from repro_torch.models import init_cache, prefill
    from repro_torch.serving import ServingEngine

    engine = ServingEngine(cfg, params, max_batch=1, max_seq_len=1024, device="cuda")
    toks, ln = _padded(torch, engine.pool, prompt)
    with torch.inference_mode():
        prefill(params, cfg, toks, init_cache(cfg, 1, 1024, device="cuda"), prompt_lengths=ln)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, cfg, toks, init_cache(cfg, 1, 1024, device="cuda"), prompt_lengths=ln)
        torch.cuda.synchronize()
        wall_unprofiled = (time.perf_counter() - t0) * 1e3
        rows, wall, attempts, _ = profiled(
            torch, lambda: prefill(params, cfg, toks, init_cache(cfg, 1, 1024, device="cuda"),
                                   prompt_lengths=ln), 1)
    busy = sum(r[0] for r in rows)
    return {"prompt_tokens": len(prompt), "bucket": int(toks.shape[1]),
            "wall_ms": wall, "wall_ms_unprofiled": wall_unprofiled, "device_busy_ms": busy,
            "attempts": attempts,
            "device_idle_share": 1.0 - busy / wall if wall else None,
            "kernels": sum(r[1] for r in rows),
            "top": [{"kernel": k[:90], "ms": ms, "calls": c} for ms, c, k in rows[:10]]}


class ScanTee:
    """While active, every prefill scan of a recurrent model (``ssd_prefill``
    as ``models/ssm.py`` calls it, ``gdn_prefill`` as ``models/gdn.py`` does)
    runs both ways on the same inputs -- the kernel and its plain version --
    and records how far they part; the walk goes on with the plain result,
    so every layer's scan sees the plain path's own activations. With
    ``perturb`` instead, the plain scan runs alone and the first call's y is
    scaled by (1 + 1e-3 noise): a quarter of a bf16 ulp, as a noise floor."""

    def __init__(self, torch, cfg, *, perturb=None):
        from repro_torch.models import gdn as gdn_mod
        from repro_torch.models import ssm as ssm_mod

        self.torch, self.perturb = torch, perturb
        self.mod, self.attr = ((ssm_mod, "ssd_prefill") if cfg.stages[0].unit[0] == "ssm"
                               else (gdn_mod, "gdn_scan_prefill"))
        self.real = getattr(self.mod, self.attr)
        self.calls, self.ok = 0, True
        self.y_err = self.y_max = self.state_err = self.state_max = 0.0

    def __call__(self, *args, plain=False):
        torch = self.torch
        y, fs = self.real(*args, plain=True)
        if self.perturb is not None:
            if self.calls == 0:
                noise = torch.randn(y.shape, generator=self.perturb, device=y.device)
                y = (y.float() * (1 + 1e-3 * noise)).to(y.dtype)
        else:
            yk, fsk = self.real(*args)
            tol = SCAN_TOL["bfloat16" if y.dtype == torch.bfloat16 else "float32"]
            self.ok &= bool(torch.allclose(yk.float(), y.float(), **tol)
                            and torch.allclose(fsk, fs, **SCAN_TOL["float32"]))
            self.y_err = max(self.y_err, (yk.float() - y.float()).abs().max().item())
            self.y_max = max(self.y_max, y.float().abs().max().item())
            self.state_err = max(self.state_err, (fsk - fs).abs().max().item())
            self.state_max = max(self.state_max, fs.abs().max().item())
        self.calls += 1
        return y, fs

    def __enter__(self):
        setattr(self.mod, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.real)
        return False


def prefill_kernel_vs_plain(torch, cfg, params, prompts) -> dict:
    """For each prompt, padded to its bucket as the pool pads it: the
    prefill kernel path against the plain path (last-token logits and every
    final state), then one decode step from each path's state with the
    kernel path's greedy token (the kernel path: the prefill scans and,
    in bf16, ``prefill_attention``). At bf16, for a model with scans, also:
    every layer's scan, kernel against plain on the same inputs
    (``ScanTee``), and the noise floor of the plain path itself (layer 0's
    scan output perturbed by a quarter of a bf16 ulp; 0 without scans)."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.serving import ServingEngine

    engine = ServingEngine(cfg, params, max_batch=1, max_seq_len=1024, device="cuda")
    bf16 = cfg.compute_dtype == "bfloat16"
    scans = _n_layers(cfg, "scan") > 0
    out = {"logits_err": 0.0, "decode_err": 0.0, "state_err": 0.0, "state_max": 0.0,
           "logit_max": 0.0, "argmax_equal": True, "buckets": []}
    if bf16:
        out.update(noise_floor_logits_err=0.0, layers_ok=True, layer_y_err=0.0,
                   layer_y_max=0.0, layer_state_err=0.0, layer_state_max=0.0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.inference_mode():
        for prompt in prompts:
            toks, ln = _padded(torch, engine.pool, prompt)
            fresh = lambda: init_cache(cfg, 1, 1024, device="cuda")
            runs = []
            for plain in (False, True):
                lg, cache, _ = prefill(params, cfg, toks, fresh(), prompt_lengths=ln, plain=plain)
                runs.append((lg.float(), cache))
            tok = torch.argmax(runs[0][0], -1).to(torch.int32)
            decoded = [decode_step(params, cfg, tok, cache, ln)[0].float() for _, cache in runs]
            if bf16 and scans:
                with ScanTee(torch, cfg) as tee:
                    prefill(params, cfg, toks, fresh(), prompt_lengths=ln)
                with ScanTee(torch, cfg, perturb=gen):
                    noisy = prefill(params, cfg, toks, fresh(), prompt_lengths=ln)[0].float()
                out["noise_floor_logits_err"] = max(out["noise_floor_logits_err"],
                                                    (noisy - runs[1][0]).abs().max().item())
                out["layers_ok"] &= tee.ok and tee.calls == _n_layers(cfg, "scan")
                for key in ("y_err", "y_max", "state_err", "state_max"):
                    out["layer_" + key] = max(out["layer_" + key], getattr(tee, key))
            torch.cuda.synchronize()
            for lg in [r[0] for r in runs] + decoded:
                if lg.shape != (1, cfg.vocab_size) or not bool(torch.isfinite(lg).all()):
                    raise SystemExit(f"prefill logits: shape {tuple(lg.shape)} or non-finite")
            out["buckets"].append(int(toks.shape[1]))
            out["logits_err"] = max(out["logits_err"], (runs[0][0] - runs[1][0]).abs().max().item())
            out["decode_err"] = max(out["decode_err"], (decoded[0] - decoded[1]).abs().max().item())
            out["logit_max"] = max(out["logit_max"], runs[1][0].abs().max().item())
            out["argmax_equal"] &= bool((runs[0][0].argmax(-1) == runs[1][0].argmax(-1)).all()
                                        and (decoded[0].argmax(-1) == decoded[1].argmax(-1)).all())
            for a, b in zip(_leaves(runs[0][1]), _leaves(runs[1][1])):
                out["state_err"] = max(out["state_err"], (a.float() - b.float()).abs().max().item())
                out["state_max"] = max(out["state_max"], b.float().abs().max().item())
    return out


def _n_layers(cfg, family=None) -> int:
    """The blocks of ``cfg``: all of them, or those of the model's decode
    kinds (``"decode"``: a decode-attention launch each decode step), its
    scan kinds (``"scan"``: a scan launch each prefill) or its
    self-attention kinds where the prefill kernel takes their calls
    (``"prefill_attn"``: bf16 and a head dim it was built for; a launch
    each prefill, none in fp32)."""
    from repro_torch.kernels.prefill_attn import HEAD_DIMS
    from repro_torch.models.model import DECODE_KINDS, SCAN_KINDS

    if family == "prefill_attn":
        if cfg.compute_dtype != "bfloat16" or cfg.head_dim not in HEAD_DIMS:
            return 0
        kinds = ("attn", "attn_global", "shared_attn")
    else:
        kinds = {"decode": DECODE_KINDS, "scan": SCAN_KINDS}.get(family)
    return sum(kinds is None or k in kinds for k in cfg.block_kinds_flat())


def step_logits(torch, cfg, params, prompts, paged, *, max_seq_len=1024, checks=1) -> dict:
    """A full-batch decode step (batch ``len(prompts)``) on copies of the
    same cache: the pool's graph replayed, its step function run eagerly,
    and (for a model with a decode kernel) the plain path. The engine first
    runs two steps (the eager warm-up, then the capture) so that its graph
    exists; with ``checks`` > 1 the pool then takes one more graph step from
    the saved cache before each further comparison. Differences are the
    largest over the checks."""
    from repro_torch.models import decode_step, decode_step_paged
    from repro_torch.serving import ServingEngine

    engine = ServingEngine(cfg, params, max_batch=len(prompts), max_seq_len=max_seq_len,
                           paged=paged, kv_block_size=16, device="cuda")
    for p in prompts:
        engine.submit(p, max_new_tokens=8)
    out = {"graph_vs_eager": 0.0, "argmax_graph_eager_equal": True}
    with torch.inference_mode():
        engine.step()
        engine.step()
        pool = engine.pool
        if pool._graph is None:
            raise SystemExit(f"{cfg.name}: no graph after two decode steps")
        for check in range(checks):
            if check:
                restore()
                engine.step()
            pool._decode_begin()                   # the next step's static inputs
            saved = [t.clone() for t in _leaves(pool.cache)]

            def restore():
                for dst, src in zip(_leaves(pool.cache), saved):
                    dst.copy_(src)

            pool._graph.replay()
            outs = {"graph": pool._graph_out[0].float().clone()}
            restore()
            outs["eager"] = pool._decode_fn()[0].float()
            if MODELS[cfg.name]["decode"]:
                restore()
                st = pool._step_in
                if paged:
                    lg, _, _ = decode_step_paged(params, cfg, st["tokens"], pool.cache,
                                                 st["lengths"], st["active"], st["tables"],
                                                 plain=True)
                else:
                    lg, _, _ = decode_step(params, cfg, st["tokens"], pool.cache, st["lengths"],
                                           plain=True)
                outs["plain"] = lg.float()
            torch.cuda.synchronize()
            for lg in outs.values():
                if lg.shape != (len(prompts), cfg.vocab_size) or not bool(torch.isfinite(lg).all()):
                    raise SystemExit(f"decode logits: shape {tuple(lg.shape)} or non-finite values")
            out["graph_vs_eager"] = max(out["graph_vs_eager"],
                                        (outs["graph"] - outs["eager"]).abs().max().item())
            out["argmax_graph_eager_equal"] &= bool((outs["graph"].argmax(-1)
                                                     == outs["eager"].argmax(-1)).all())
            if "plain" in outs:
                agree = (outs["eager"].argmax(-1) == outs["plain"].argmax(-1)).float().mean()
                out["kernel_vs_plain"] = max(out.get("kernel_vs_plain", 0.0),
                                             (outs["eager"] - outs["plain"]).abs().max().item())
                out["argmax_agreement"] = min(out.get("argmax_agreement", 1.0), agree.item())
                out["max_logit"] = max(out.get("max_logit", 0.0),
                                       outs["plain"].abs().max().item())
        out["lengths"] = pool._step_in["lengths"].tolist()
    return out


def main_case(torch, name) -> tuple:
    """(dtype name, inputs, keyword arguments) of ``name``'s timed main case,
    as phase 3 times it."""
    for case in KERNEL_CASES + MLA_CASES:
        if case.name == name and case.main:
            make = make_mla_inputs if isinstance(case, Mla) else make_inputs
            return ("bfloat16", make(torch, case, torch.bfloat16, seed=case_seed(case)),
                    case_kwargs(case))
    if name == "prefill_attention":
        return prefill_attn_case(torch, next(c for c in PREFILL_ATTN_CASES if c.main))
    if name in SCAN_BWD_TIMED_DTYPE:
        dname = SCAN_BWD_TIMED_DTYPE[name]
        case = next(c for c in (SSD_BWD_CASES if name == "ssd_scan_bwd" else GDN_BWD_CASES)
                    if c[-1])
        args, _ = make_scan_bwd_args(torch, name, case[:-1], getattr(torch, dname),
                                     seed=case_seed((name, *case)))
        return dname, args, {}
    cases, make = {"ssd_scan": (SSD_CASES, make_ssd_inputs),
                   "gdn_scan": (GDN_CASES, make_gdn_inputs)}[name]
    dname = SCAN_TIMED_DTYPE[name]
    case = next(c for c in cases if c[-1])
    return dname, make(torch, case[:-1], getattr(torch, dname),
                       seed=case_seed((name, *case))), {}


def load_kernels(torch, src: Path):
    """``repro_torch.kernels`` of the checkout whose package lies in ``src``,
    built, imported afresh beside any loaded before, and each of its kernels
    called once: a wrapper binds its library at its first call, which must
    come while its own package is the one imported."""
    for mod in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[mod]
    sys.path.insert(0, str(src))
    try:
        from repro_torch import kernels as kmod
        from repro_torch.kernels import build

        build.build_all()
        for name in COUNTED:
            if hasattr(kmod, name):
                _, inputs, kwargs = main_case(torch, name)
                getattr(kmod, name)(*inputs, **kwargs)
        torch.cuda.synchronize()
    finally:
        sys.path.remove(str(src))
    return kmod


AGAINST_ROUNDS = 3       # rounds of (DIR, this, this, DIR): single turns vary by up to ~4 %


def time_against(torch, other: Path) -> None:
    """``--against DIR``: each kernel's main case, timed as phase 3 times it
    (CUDA-graph device ms), for the checkout in DIR and for this one, on the
    same inputs in one process, in AGAINST_ROUNDS rounds of turns (DIR,
    this, this, DIR) so that a drift of the card's clock shows. One JSON
    line per kernel both have, every turn and each side's median."""
    import statistics

    kmods = {"against": load_kernels(torch, other.resolve() / "src"),
             "this": load_kernels(torch, SRC)}
    for name in COUNTED:
        if not hasattr(kmods["against"], name):
            continue
        dname, inputs, kwargs = main_case(torch, name)
        sets = cold_sets(inputs)
        ms = {"against": [], "this": []}
        for side in ("against", "this", "this", "against") * AGAINST_ROUNDS:
            kernel = getattr(kmods[side], name)
            ms[side].append(cuda_time_ms(torch, lambda *a: kernel(*a, **kwargs), sets)[0])
        median = {side: statistics.median(v) for side, v in ms.items()}
        print(json.dumps({"kernel": name, "dtype": dname, "against": str(other), "ms": ms,
                          "median_ms": median,
                          "this_over_against": median["this"] / median["against"]}))
        del sets


STEP_TURNS = ("against", "this", "this", "against")


def step_turn(torch, src: Path, arch: str) -> None:
    """One turn of ``--steps``, in a process of its own: ``arch`` served as
    phase 4 serves it in bf16 (the same weights, prompts and warm-up; dense
    then paged; the decode step replayed from a CUDA graph and profiled)
    with the package in ``src``. One JSON line per layout: the steady
    batch-8 step ms (host clock), a graph replay's device ms (CUDA events)
    and the profiled device-busy ms and kernels a step."""
    sys.path.insert(0, str(src))
    from repro_torch import kernels as kmod
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine
    from repro_torch.training import make_prompts

    build.build_all()
    cfg = get_config(arch)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    prompts = make_prompts(cfg, 8, 64, 512, seed=0)
    warm = ServingEngine(cfg, params, max_batch=8, max_seq_len=1024, device="cuda")
    warm.submit(prompts[0], max_new_tokens=4)
    warm.run_to_completion()
    del warm
    for paged in (False, True):
        engine, _, info = serve(torch, cfg, params, prompts, paged=paged, max_new=32,
                                kmod=kmod, profile=True)
        steps = info["step_ms_batch8"]
        print(json.dumps({"arch": arch, "paged": paged, "step_ms": sum(steps) / len(steps),
                          "replay_device_ms": info["replays_timed"]["replay_device_ms"],
                          "device_busy_ms": info["profile"]["device_busy_ms_per_step"],
                          "kernels_per_step": info["profile"]["kernels_per_step"]}), flush=True)
        del engine


def time_steps(other: Path, archs) -> None:
    """``--steps``: each arch's ``step_turn`` for the checkout in DIR and for
    this one, in turns (DIR, this, this, DIR), each turn a process of its
    own (the two checkouts' packages share a name). One JSON line per turn
    and layout, then per layout each side's mean and this over DIR."""
    rows = []
    for arch in archs:
        for side in STEP_TURNS:
            src = (other.resolve() if side == "against" else ROOT) / "src"
            run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--step-turn",
                                  str(src), arch], stdout=subprocess.PIPE, text=True, check=True)
            for line in run.stdout.splitlines():
                if line.startswith("{"):
                    rows.append({"side": side, **json.loads(line)})
                    print(json.dumps(rows[-1]), flush=True)
    keys = ("step_ms", "replay_device_ms", "device_busy_ms", "kernels_per_step")
    for arch in archs:
        for paged in (False, True):
            mean = {side: {k: sum(r[k] for r in rows if (r["side"], r["arch"], r["paged"])
                                  == (side, arch, paged)) / STEP_TURNS.count(side)
                           for k in keys} for side in ("against", "this")}
            print(json.dumps({"steps": arch, "paged": paged, "against": str(other), "mean": mean,
                              "this_over_against": {k: mean["this"][k] / mean["against"][k]
                                                    for k in keys}}))


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one card.")
    ap.add_argument("--against", type=Path, metavar="DIR",
                    help="only time every kernel's main case beside the kernels of the "
                         "checkout in DIR (e.g. a git archive of another commit)")
    ap.add_argument("--steps", nargs="+", default=(), metavar="ARCH",
                    help="with --against: also time each ARCH's phase-4 bf16 decode step, "
                         "dense and paged, for both checkouts, in turns (DIR, this, this, "
                         "DIR), each a process of its own")
    ap.add_argument("--step-turn", nargs=2, metavar=("SRC", "ARCH"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.step_turn:
        step_turn(torch, Path(args.step_turn[0]), args.step_turn[1])
        return 0
    if args.against:
        print(f"[device] {torch.cuda.get_device_name(0)}")
        print(nvidia_smi("name,power.limit"))
        time_against(torch, args.against)
        time_steps(args.against, args.steps)
        return 0
    sys.path.insert(0, str(SRC))
    dry, pod = DryRunProcess(), PodDryRunProcess()
    try:
        return smoke(torch, F, dry, pod)
    finally:
        dry.stop()
        pod.stop()


def smoke(torch, F, dry, pod) -> int:
    """Phases 1-15 (the module docstring); ``dry`` is the dry run's process,
    which ``[paper]`` waits for, ``pod`` the pod dry run's, which ``[mesh]``
    waits for."""
    from repro_torch import kernels as kmod
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    # ---- 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi_line = nvidia_smi("name,power.limit")
    print(f"[device] {kind} count={count} torch={torch.__version__} cuda={torch.version.cuda}")
    print(smi_line)

    # ---- 2. build
    t0 = time.perf_counter()
    info = build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s wall")
    for name, rec in info.items():
        print(f"[build] {name}: {rec['seconds']:.1f} s -> {rec['path']}")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line.lower():
                print(f"[build]   {line.strip()}")
    for line in tensor_core_check(info):
        print(f"[sass] {line}")

    # ---- 3. kernels vs plain versions
    records = check_kernels(torch, F, kmod)
    check_lse(torch, kmod)
    check_aliased_pages(torch, kmod)
    check_scan_kernels(torch, kmod, records)
    check_scan_bwd_kernels(torch, kmod, records)
    check_prefill_attention(torch, F, kmod, records)
    check_ssd_groups(torch, kmod)
    check_prng(torch)

    # ---- 4. full-width models through ServingEngine
    for arch in MODELS:
        serve_model(torch, kmod, get_config(arch), records)

    # ---- 4b. [mesh]: the multi-device layer on a one-rank mesh, the pod dry run
    mesh_phase(torch, kmod, records, pod)

    # ---- 5-10. the disaggregated serving stack at full width
    params_for = cluster_phase(torch, kmod, records)
    trace_phase(torch, kmod, records, params_for)
    del params_for
    torch.cuda.empty_cache()
    fleet_phase(torch, kmod, records)
    autoscale_phase(torch, kmod, records)
    prefix_phase(torch, kmod, records)
    events_phase(torch, kmod, records)

    # ---- 11. serve_scale's 100-replica fleet in fp32, on replica banks
    scale_phase(torch, kmod, records)

    # ---- 12. the paper's analysis drivers, the dry run, kernels_micro
    paper_phase(torch, kmod, records, dry)

    # ---- 13. training at full width
    train_phase(torch, kmod, records)

    # ---- 14. the examples and scripts on the card
    examples_phase(torch, kmod)

    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi("name,power.limit"))
    print(json.dumps({"kernels": [records[name] for name in COUNTED]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


def serve_model(torch, kmod, cfg, records) -> None:
    """Phase 4 for one full-width model: bf16 serving dense then paged, each
    with the decode step replayed from a CUDA graph, and dense then eager
    on the same prompts (greedy streams equal; the model's decode kernel launched
    once per layer and decode step, eager launches plus replays x captured
    launches, its prefill scan once per layer and prefill call, the others
    never), one full-batch step graph vs eager (and kernel vs plain) on
    copies of one cache, the bf16 prefill kernel vs plain path, then fp32
    graph engines (dense, paged) whose greedy streams must agree. The eager
    runs are bf16 on the dense layout only (``EAGER_LAYOUTS``,
    ``FP32_LAYOUTS``). Adds each main-path launch count (the bf16 graph
    runs, dense and paged) to ``records``."""
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine
    from repro_torch.training import make_prompts

    arch = cfg.name
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {arch} {cfg.param_dtype}: {n_params / 1e9:.3f} B params, "
          f"{_n_layers(cfg)} layers ({_n_layers(cfg, "decode")} attention, "
          f"{_n_layers(cfg, "scan")} recurrent), init {time.perf_counter() - t0:.1f} s")
    prompts = make_prompts(cfg, 8, 64, 512, seed=0)
    warm = ServingEngine(cfg, params, max_batch=8, max_seq_len=1024, device="cuda")
    warm.submit(prompts[0], max_new_tokens=4)
    warm.run_to_completion()              # cuBLAS, allocator and graph warm-up
    del warm
    torch.cuda.reset_peak_memory_stats()
    t_bf16 = time.perf_counter()
    for paged in (False, True):
        tag = "paged" if paged else "dense"
        side = {}
        for graphs in EAGER_LAYOUTS[paged] if arch in EAGER_ARCHS else (True,):
            mode = "graph" if graphs else "eager"
            engine, reqs, info = serve(torch, cfg, params, prompts, paged=paged, max_new=32,
                                       kmod=kmod, graphs=graphs, profile=True)
            st = engine.stats
            eos = cfg.eos_token_id
            for r in reqs:
                if not (r.done and (len(r.output) == 32 or r.output[-1] == eos)):
                    raise SystemExit(f"{arch} {tag} {mode}: request {r.uid} did not finish: "
                                     f"{r.output}")
            check_launches(arch, f"{tag} {mode}", paged, cfg, st, info)
            if graphs:
                for name, n in info["launches"].items():
                    records[name]["launches"] += n
            steps = info["step_ms_batch8"]
            run = {
                "requests": len(reqs), "prefill_tokens": st.prefill_tokens,
                "decode_tokens": st.decode_tokens, "decode_steps": st.decode_steps,
                "prefill_tok_s": st.prefill_tokens / st.prefill_s,
                "decode_tok_s": st.decode_tokens / st.decode_s,
                "decode_step_ms_batch8_mean": sum(steps) / len(steps) if steps else None,
                "decode_step_ms_batch8_n": len(steps),
                "decode_tok_s_batch8": 8e3 * len(steps) / sum(steps) if steps else None,
                "modelled_decode_j": st.decode_j, "modelled_prefill_j": st.prefill_j,
                "lock_clock_mhz": st.actual_clock_mhz,
                "smi_during_run": info["smi"],
                "prefill_calls": info["prefill_calls"],
                "kernel_launches": {k: n for k, n in info["launches"].items() if n},
                "counted_launches": {k: n for k, n in info["counted"].items() if n},
                "graph_replays": info["graph_replays"],
                "captured_launches": info["captured_launches"],
                "capture_ms": info["capture_ms"],
                "dispatches": engine.pool.jit_dispatches,
                "profile": info["profile"],
                "replays_timed": info["replays_timed"],
            }
            if paged:
                run["traffic_bytes"] = engine.pool.traffic.total_bytes
            print(f"[serve] {arch} {tag} {mode}: " + json.dumps(run))
            side[mode] = (run, [r.output for r in reqs])
            del engine
        if "eager" not in side:
            continue
        if side["graph"][1] != side["eager"][1]:
            raise SystemExit(f"{arch} {tag} bf16: graph and eager greedy streams differ")
        print(f"[serve] {arch} {tag} bf16 graph vs eager: " + json.dumps(side_by_side(side))
              + ", greedy streams equal")
    if arch == SAMPLED_ARCH:
        sampled_runs(torch, kmod, cfg, params, prompts, side["graph"][1])
    print(f"[serve] {arch} max_memory_allocated={torch.cuda.max_memory_allocated()} bytes; "
          f"bf16 serving {time.perf_counter() - t_bf16:.1f} s")
    longest = max(prompts, key=len)
    print(f"[serve] {arch} prefill profile: "
          + json.dumps(profile_prefill(torch, cfg, params, longest)))

    atol = LOGIT_ATOL_BF16[arch]
    short_long = [min(prompts, key=len), longest]      # buckets 64 and 512
    if MODELS[arch]["prefill"]:
        cmp = prefill_kernel_vs_plain(torch, cfg, params, short_long)
        print(f"[serve] {arch} bf16 prefill kernel vs plain: " + json.dumps(cmp)
              + f" (every layer's scan at {SCAN_TOL}; logits within max({atol}, 2 x the "
              f"noise floor), the floor 0 without scans)")
        if not (cmp["layers_ok"]
                and cmp["logits_err"] <= max(atol, 2 * cmp["noise_floor_logits_err"])):
            raise SystemExit(f"{arch}: kernel-path prefill disagrees with the plain path")
    for paged in (False, True):
        tag = "paged" if paged else "dense"
        cmp = step_logits(torch, cfg, params, prompts, paged)
        print(f"[serve] {arch} {tag} bf16 step logits: " + json.dumps(cmp)
              + (f" (kernel vs plain atol {atol})" if "kernel_vs_plain" in cmp else ""))
        if "kernel_vs_plain" in cmp and not cmp["kernel_vs_plain"] <= atol:
            raise SystemExit(f"{arch} {tag}: kernel-path logits disagree with the plain path")
    if arch in LONG_CONTEXT:
        long_context_check(torch, cfg, params, **LONG_CONTEXT[arch])

    # fp32: the same seed's draws, unrounded (the bf16 weights are their
    # rounding), made after the bf16 weights are freed: deepseek-v2-lite-16b
    # and nemotron-4-15b hold 62 GB each in fp32
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    del params
    torch.cuda.empty_cache()
    params32 = init_params(cfg32, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    streams = {}
    t_fp32 = time.perf_counter()
    for paged in (False, True):
        tag = "paged" if paged else "dense"
        for graphs in FP32_LAYOUTS[paged]:
            engine, reqs, info = serve(torch, cfg32, params32, prompts, paged=paged, max_new=8,
                                       kmod=kmod, graphs=graphs)
            streams[tag, graphs] = [r.output for r in reqs]
            check_launches(arch, f"fp32 {tag}", paged, cfg32, engine.stats, info)
            print(f"[serve] {arch} fp32 {tag} {'graph' if graphs else 'eager'}: launches "
                  f"{ {k: n for k, n in info['launches'].items() if n} }, replays "
                  f"{info['graph_replays']}, first stream {streams[tag, graphs][0]}")
            del engine
    if len({json.dumps(v) for v in streams.values()}) != 1:
        raise SystemExit(f"{arch}: fp32 greedy streams differ between dense / paged")
    print(f"[serve] {arch} fp32 greedy streams equal, dense == paged: ok; fp32 serving "
          f"{time.perf_counter() - t_fp32:.1f} s")
    if _n_layers(cfg32, "scan"):
        cmp = prefill_kernel_vs_plain(torch, cfg32, params32, short_long)
        print(f"[serve] {arch} fp32 prefill kernel vs plain: " + json.dumps(cmp)
              + f" (atol {LOGIT_ATOL_FP32}, states within {LOGIT_ATOL_FP32} x max |state|)")
        if not (cmp["logits_err"] <= LOGIT_ATOL_FP32 and cmp["decode_err"] <= LOGIT_ATOL_FP32
                and cmp["state_err"] <= LOGIT_ATOL_FP32 * cmp["state_max"]
                and cmp["argmax_equal"]):
            raise SystemExit(f"{arch}: fp32 kernel-path prefill disagrees with the plain path")
    del params32
    torch.cuda.empty_cache()
    print(f"[serve] {arch} phase done in {time.perf_counter() - t0:.1f} s")


def long_context_check(torch, cfg, params, *, max_seq_len, prompt_tokens, checks) -> None:
    """Phase 4 past the sliding window: two requests of ``prompt_tokens``
    (lo, hi) tokens in a cache of ``max_seq_len``, dense and paged (blocks
    of 16), graph against eager and kernel against plain logits over
    ``checks`` decode steps, within the model's LOGIT_ATOL_BF16. At
    ``max_seq_len`` 1024 the window is never reached."""
    from repro_torch.training import make_prompts

    t0 = time.perf_counter()
    prompts = make_prompts(cfg, 2, *prompt_tokens, seed=7)
    atol = LOGIT_ATOL_BF16[cfg.name]
    for paged in (False, True):
        tag = "paged" if paged else "dense"
        cmp = step_logits(torch, cfg, params, prompts, paged, max_seq_len=max_seq_len,
                          checks=checks)
        print(f"[serve] {cfg.name} {tag} bf16 long context (prompts {[len(p) for p in prompts]}, "
              f"max_seq_len {max_seq_len}, window {cfg.sliding_window}): " + json.dumps(cmp)
              + f" (kernel vs plain atol {atol})")
        if not (cmp["kernel_vs_plain"] <= atol and min(cmp["lengths"]) > cfg.sliding_window):
            raise SystemExit(f"{cfg.name} {tag}: long-context kernel-path logits disagree "
                             "with the plain path, or the window was not passed")
    torch.cuda.empty_cache()
    print(f"[serve] {cfg.name} long context done in {time.perf_counter() - t0:.1f} s")


def zero_counts(torch, kmod) -> None:
    """Every counted wrapper's launch count set to 0 (the card idle first)."""
    torch.cuda.synchronize()
    for name in COUNTED:
        getattr(kmod, name).launches = 0


def check_stack_launches(torch, kmod, replicas, what, records=None, graphs=True,
                         batched=None) -> dict:
    """Launches of one run across the replicas' prefill and decode pools,
    read just after it: each counted wrapper's count plus, for every pool,
    its graph replays x the launches its capture recorded. Each must equal
    ``expected_launches`` summed over the replicas (the arch's decode
    kernel layers x the decode pool's own steps, its scan layers x the
    prefill pool's prefill calls, every other kernel 0), and a
    graph-replaying decode pool must have run exactly one of its own steps
    eagerly. ``batched`` (``Fleet.last_batched_calls``) adds the event
    engine's replica banks: per config, its decode kernel's layers once per
    bank step (the whole group's step) and the launches the bank graphs'
    replays ran; a pool that stepped inside a bank took its other steps
    itself, and may have taken none (no eager step). A batched prefill call
    prefills several requests with one launch per scan or attention layer;
    a prefix hit's suffix prefill launches no ``prefill_attention``. Adds
    the launches to ``records``' main-path counts when given."""
    torch.cuda.synchronize()
    got = {name: getattr(kmod, name).launches for name in COUNTED}
    want = dict.fromkeys(COUNTED, 0)
    batched = batched or {}
    by_cfg = {}
    for r in replicas:
        dp = r.decode_pool
        by_cfg.setdefault(r.cfg.name, r)
        for pool in r.pools().values():
            for name, n in pool.captured_launches.items():
                got[name] += pool.graph_replays * n
        own = dp._decode_steps_run
        hits = sum(p.prefix_stats.hits for p in {id(p): p for p in r.pools().values()}.values())
        for name, n in expected_launches(r.arch, dp.paged, r.cfg, r.stats,
                                         decode_steps=own, suffix_prefills=hits).items():
            want[name] += n
        steps, replays = r.decode_stats.decode_steps, dp.graph_replays
        if (own + dp.bank_steps != steps or replays != (max(own - 1, 0) if graphs else 0)
                or r.prefill_pool.graph_replays):
            raise SystemExit(f"{what} {r.name}: {replays} graph replays in {own} own decode "
                             f"steps and {dp.bank_steps} bank steps of {steps} "
                             f"(graphs={graphs})")
    for cfg_name, ent in batched.items():
        r = by_cfg[cfg_name]
        for name, n in ent["replay_launches"].items():
            got[name] += n
        for name, n in expected_launches(
                r.arch, False, r.cfg, r.stats, decode_steps=ent["decode_steps"],
                prefill_calls=ent["prefill_calls"] - ent["prefill_requests"]).items():
            want[name] += n
    if got != want:
        raise SystemExit(f"{what}: launches {got} != {want}")
    if records is not None:
        for name, n in got.items():
            records[name]["launches"] += n
    return {k: n for k, n in got.items() if n}


def cluster_phase(torch, kmod, records) -> dict:
    """Phase 5, ``[cluster]``: ``serve_cluster.run`` at full width (bf16,
    random weights from a seeded generator) on the card, the recipe and
    assertions ``python -m repro_torch.benchmarks.serve_cluster
    --full-config`` runs, after one unmeasured warm-up run per arch. Each
    run's launch invariant across the two pools is read as it ends
    (``on_run``), which then sets the counts to 0 for the next run. Then
    each arch's lock mode again with ``cuda_graphs=False``, whose greedy
    streams must equal those of every mode's graph run. Returns
    {arch: weights}."""
    from repro_torch.benchmarks import serve_cluster as sc
    from repro_torch.benchmarks.common import random_params
    from repro_torch.configs import get_config

    params_for, streams, rows = {}, {}, {}
    t_phase = time.perf_counter()
    for arch in sc.ARCHS:
        t0 = time.perf_counter()
        cfg, params = get_config(arch), random_params(arch, full_config=True)
        torch.cuda.synchronize()
        params_for[arch] = params
        n_params = sum(t.numel() for t in _leaves(params))
        print(f"[cluster] {arch} {cfg.param_dtype}: {n_params / 1e9:.3f} B params, "
              f"{_n_layers(cfg)} layers, init {time.perf_counter() - t0:.1f} s")
        sc.serve(arch, "lock", requests=2, params=params, full_config=True)    # warm-up

    def report(row, cluster, reqs, graphs=True):
        tag = f"{row['arch']} {row['mode']} {'graph' if graphs else 'eager'}"
        launches = check_stack_launches(torch, kmod, [cluster._replica], f"[cluster] {tag}",
                                        records if graphs else None, graphs,
                                        cluster._fleet.last_batched_calls)
        streams.setdefault(row["arch"], {})[tag] = [r.output for r in reqs]
        rows[tag] = row
        run = row["run"]
        print(f"[cluster] {tag}: " + json.dumps({
            "completed": row["completed"], "decode_tok_per_j": row["decode_tokens_per_j"],
            "decode_clock_mhz": row["decode_clock_mhz"],
            "prefill_clock_mhz": row["prefill_clock_mhz"],
            "lever_engaged": row["decode_engaged"], "peak_occupancy": row["peak_occupancy"],
            "decode_bytes": row["decode_read_bytes"] + row["decode_write_bytes"],
            "steady_decode_tok_s": run["steady_decode_tok_s"],
            "steady_decode_steps": run["steady_decode_steps"], "wall_s": run["wall_s"],
            "decode_steps": run["decode_steps"], "prefill_calls": run["prefill_calls"],
            "graph_replays": run["graph_replays"],
            "captured_launches": {k: n for k, n in
                                  cluster.decode_pool.captured_launches.items() if n},
            "host_ms_per_step": run["host_ms_per_step"], "launches": launches}))
        zero_counts(torch, kmod)        # the next run starts from 0

    zero_counts(torch, kmod)
    for name, _, derived in sc.run(full_config=True, device="cuda", params_for=params_for,
                                   on_run=report):
        print(f"[cluster] {name}: {derived}")
    for arch in sc.ARCHS:
        zero_counts(torch, kmod)
        row, cluster, reqs = sc.serve(arch, "lock", params=params_for[arch], full_config=True,
                                      device="cuda", cuda_graphs=False)
        report(row, cluster, reqs, graphs=False)
        if len({json.dumps(v) for v in streams[arch].values()}) != 1:
            raise SystemExit(f"[cluster] {arch}: greedy streams differ between the modes or "
                             "between graph and eager")
        lock, cap = rows[f"{arch} lock graph"], rows[f"{arch} cap graph"]
        print(f"[cluster] {arch}: lock {lock['decode_tokens_per_j']:.1f} >= cap "
              f"{cap['decode_tokens_per_j']:.1f} decode tok/J, cap inert at the default "
              f"{cap['decode_clock_mhz']:.0f} MHz, streams equal across modes and graph == "
              f"eager: ok")
    print(f"[cluster] phase done in {time.perf_counter() - t_phase:.1f} s")
    return params_for


def trace_phase(torch, kmod, records, params_for) -> None:
    """Phase 6, ``[trace]``: ``serve_trace.run(smoke=True)`` at full width,
    the recipe and assertions ``python -m repro_torch.benchmarks.serve_trace
    --smoke --full-config`` runs: 60-request traces made against the full
    config, replayed through ``Cluster.from_spec`` on a ``VirtualClock``
    with the event engine (the default, as in the reference), the claims
    per arch and a byte-identical second replay. Each replay's launch invariant and wall seconds are read
    as it ends (``on_run``), which then sets the counts to 0 for the
    next."""
    from repro_torch.benchmarks import serve_trace as st

    def report(row, wall_s, cluster):
        tag = f"{row['arch']} {row['mode']}"
        launches = check_stack_launches(torch, kmod, [cluster._replica], f"[trace] {tag}",
                                        records, batched=cluster._fleet.last_batched_calls)
        print(f"[trace] {tag}: " + json.dumps({
            "completed": row["completed"], "decode_j": row["decode_j"],
            "p99_tbt_s": row["p99_tbt_s"], "tbt_target_s": row["tbt_target_s"],
            "slo_met": row["slo_met"], "decode_clock_mhz": row["decode_clock_mhz"],
            "engaged": row["decode_engaged"], "transitions": row["transitions"],
            "decode_steps": cluster.decode_stats.decode_steps,
            "graph_replays": cluster.decode_pool.graph_replays, "wall_s": wall_s,
            "launches": launches}))
        zero_counts(torch, kmod)        # the next replay starts from 0

    t_phase = time.perf_counter()
    zero_counts(torch, kmod)
    for name, _, derived in st.run(smoke=True, full_config=True, device="cuda",
                                   params_for=params_for, on_run=report):
        print(f"[trace] {name}: {derived}")
    print(f"[trace] phase done in {time.perf_counter() - t_phase:.1f} s")


def stack_report(torch, fleet, m, wall_s) -> dict:
    """What ``[fleet]`` and ``[autoscale]`` print of one replay beside the
    recipe's figures: requests and decode steps per replica, the engine's
    fused and serial decode dispatches, graph captures and replays per
    decode pool, wall seconds and device memory."""
    st = fleet.last_engine_stats
    return {
        "completed": m["completed"], "total_j": m["total_j"], "p99_tbt_s": m["p99_tbt_s"],
        "decode_tokens": m["decode_tokens"],
        "requests_by_replica": {n: d["completed"] for n, d in m["replicas"].items()},
        "decode_steps": {r.name: r.decode_stats.decode_steps for r in fleet.replicas},
        "fused_decode_calls": st.fused_decode_calls,
        "serial_decode_calls": st.serial_decode_calls,
        "graph_captures": {r.name: int(r.decode_pool._graph is not None)
                           for r in fleet.replicas},
        "graph_replays": {r.name: r.decode_pool.graph_replays for r in fleet.replicas},
        "bank_steps": {r.name: r.decode_pool.bank_steps for r in fleet.replicas},
        "banks": bank_report(fleet),
        "wall_s": wall_s, "memory_allocated": torch.cuda.memory_allocated()}


def bank_report(fleet) -> dict:
    """The replay's replica banks per config (``Fleet.last_batched_calls``):
    bank steps, graph captures and replays, batched prefill calls and the
    requests they served."""
    return {name: {k: v for k, v in ent.items() if k != "replay_launches"}
            for name, ent in (fleet.last_batched_calls or {}).items()}


def fleet_phase(torch, kmod, records) -> None:
    """Phase 7, ``[fleet]``: ``serve_fleet.run(smoke=True)`` at full width,
    the recipe and assertions ``python -m repro_torch.benchmarks.serve_fleet
    --smoke --full-config`` runs: qwen3-4b, minitron-4b-mla and gdn-4b
    (bf16, paged batch 8, 128 blocks of 8; six pools on one card) behind
    jsq / energy / affinity under lock and slo, the all-qwen3-4b fleet on
    one weight set, one replica drained, the repeat; 120 diurnal requests
    a replay on the event engine. Each replay's launch invariant across its
    pools, dispatches, graphs and wall seconds are read as it ends
    (``on_run``), which then sets the counts to 0 for the next. Where the
    recipe fails on ``FLEET_CAVEAT`` alone, its figures are printed and
    the phase passes; any other violation fails it, and any other error
    propagates as it is."""
    from repro_torch.benchmarks import serve_fleet as sf
    from repro_torch.benchmarks.common import RecipeViolation, random_params

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params_for = {}
    for arch in sf.HET_ARCHS:
        t0 = time.perf_counter()
        params_for[arch] = random_params(arch, full_config=True)
        torch.cuda.synchronize()
        print(f"[fleet] {arch}: init {time.perf_counter() - t0:.1f} s")

    results = {}

    def report(m, wall_s, fleet):
        tag = (f"{'homo-gqa' if m['archs'] == list(sf.HOMO_ARCHS) else 'het'}/"
               f"{m['routing']}/{m['mode']}{'/drain1' if m['drained'] else ''}")
        results[tag] = m
        launches = check_stack_launches(torch, kmod, fleet.replicas, f"[fleet] {tag}", records,
                                        batched=fleet.last_batched_calls)
        print(f"[fleet] {tag}: " + json.dumps({**stack_report(torch, fleet, m, wall_s),
                                               "launches": launches}))
        zero_counts(torch, kmod)        # the next replay starts from 0

    zero_counts(torch, kmod)
    try:
        for name, _, derived in sf.run(smoke=True, full_config=True, device="cuda",
                                       params_for=params_for, on_run=report):
            print(f"[fleet] {name}: {derived}")
    except RecipeViolation as e:
        caveat = [v for v in sf.claim_violations(results) if FLEET_CAVEAT in v]
        if not caveat or sorted(e.violations) != sorted(caveat):
            raise SystemExit(f"[fleet]: {'; '.join(e.violations)}")
        for mode in sf.MODES:
            jsq, ea = results[f"het/jsq/{mode}"], results[f"het/energy/{mode}"]
            print(f"[fleet] caveat {mode}: energy {ea['total_j']:.3f} J vs jsq "
                  f"{jsq['total_j']:.3f} J, p99 TBT {ea['p99_tbt_s']:.5f} vs "
                  f"{jsq['p99_tbt_s']:.5f} s, decode tokens {ea['decode_tokens']} vs "
                  f"{jsq['decode_tokens']}")
        het, homo = results["het/affinity/lock"], results["homo-gqa/affinity/lock"]
        print(f"[fleet] every other check holds: het affinity {het['total_j']:.3f} J < homo "
              f"{homo['total_j']:.3f} J, completion, drained replica at 0 J, equal repeat")
    del params_for
    torch.cuda.empty_cache()
    print(f"[fleet] max_memory_allocated={torch.cuda.max_memory_allocated()} bytes")
    print(f"[fleet] phase done in {time.perf_counter() - t_phase:.1f} s")


def autoscale_phase(torch, kmod, records) -> None:
    """Phase 8, ``[autoscale]``: ``serve_autoscale.run(smoke=True)`` at full
    width, the recipe and assertions ``python -m
    repro_torch.benchmarks.serve_autoscale --smoke --full-config`` runs:
    four dense qwen3-4b replicas on one weight set (bf16, batch 8; eight
    pools on one card) behind jsq, static4 / queue / schedule on 120
    diurnal requests, the 30-request valley replay, the schedule repeat,
    each under the recipe's 60 s budget. Each replay's launch invariant,
    ``ScaleEvent``s, joules, p99 TBT, ramp TTFT, dispatches, graphs and
    wall seconds are read as it ends (``on_run``), which then sets the
    counts to 0 for the next."""
    from repro_torch.benchmarks import serve_autoscale as sa
    from repro_torch.benchmarks.common import random_params

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = random_params(sa.ARCH, full_config=True)
    torch.cuda.synchronize()
    print(f"[autoscale] {sa.ARCH}: init {time.perf_counter() - t_phase:.1f} s")

    def report(m, wall_s, fleet):
        tag = f"{m['mode']} ({m['requests']} requests)"
        launches = check_stack_launches(torch, kmod, fleet.replicas, f"[autoscale] {tag}",
                                        records, batched=fleet.last_batched_calls)
        print(f"[autoscale] {tag}: " + json.dumps({
            **stack_report(torch, fleet, m, wall_s), "ramp_ttft_s": m["ramp_ttft_s"],
            "scale_events": [[e["t_s"], e["action"], e["replica"]] for e in m["scale_events"]],
            "launches": launches}))
        zero_counts(torch, kmod)        # the next replay starts from 0

    zero_counts(torch, kmod)
    for name, _, derived in sa.run(smoke=True, full_config=True, device="cuda",
                                   params_for={sa.ARCH: params}, on_run=report):
        print(f"[autoscale] {name}: {derived}")
    del params
    torch.cuda.empty_cache()
    print(f"[autoscale] max_memory_allocated={torch.cuda.max_memory_allocated()} bytes")
    print(f"[autoscale] phase done in {time.perf_counter() - t_phase:.1f} s")


def _aliased_steps(pool_cls):
    """Count, per decode pool, the decode steps whose live block-table rows
    name a page more than once (prefix sharing): wraps
    ``Pool._decode_begin`` until the returned function restores it;
    returns (counts {id(pool): steps}, restore)."""
    counts, original = {}, pool_cls._decode_begin

    def counted(self, *args, **kw):
        pre = original(self, *args, **kw)
        if pre is not None and self.paged:
            pages = self.block_tables[pre["active"]]
            pages = pages[pages != 0]
            if len(pages) != len(set(pages.tolist())):
                counts[id(self)] = counts.get(id(self), 0) + 1
        return pre

    pool_cls._decode_begin = counted
    return counts, lambda: setattr(pool_cls, "_decode_begin", original)


def _first_parting(streams) -> dict:
    """Where token streams of one trace (lists of (prompt, output) by
    arrival, one per config) first part: the request and the step."""
    names = list(streams)
    base = streams[names[0]]
    for i, (prompt, out) in enumerate(base):
        for name in names[1:]:
            other = streams[name][i][1]
            if other != out:
                step = next((j for j, (a, b) in enumerate(zip(out, other)) if a != b),
                            min(len(out), len(other)))
                return {"request": i, "prompt_len": len(prompt), "step": step,
                        "configs": [names[0], name], "tokens": [out[step:step + 3],
                                                                other[step:step + 3]]}
    return {}


def prefix_phase(torch, kmod, records) -> None:
    """Phase 9, ``[prefix]``: ``serve_prefix.run(smoke=True)`` at full width
    (gemma-2b, lock, batch 8, ``max_seq_len`` 128, blocks of 16, 192
    pages; shares 0 / 0.5 / 1 through dense, paged and cow fleets, the
    routing pair on two replicas, the repeat replay), the recipe and
    assertions ``python -m repro_torch.benchmarks.serve_prefix --smoke
    --full-config`` runs, on the event engine, in bf16. Each replay's
    launch invariant across its pools, prefix counters, p99 TTFT, wall
    seconds and kernel 2's launches over aliased tables (steps whose live
    rows share a page x layers) are read as it ends (``on_run``). Where the
    recipe's checks fail, the first point at which the streams of dense /
    paged / cow part is printed for every share whose three replays ran
    (another GEMM shape for the suffix prefill, another attention kernel:
    random-weight bf16 stacks are chaotic), and the phase fails; any other
    error propagates as it is."""
    from repro_torch.benchmarks import serve_prefix as sp
    from repro_torch.benchmarks.common import random_params
    from repro_torch.configs import get_config
    from repro_torch.serving.pool import Pool

    t_phase = time.perf_counter()
    n_layers = _n_layers(get_config(sp.ARCH))
    params = random_params(sp.ARCH, full_config=True)
    torch.cuda.synchronize()
    print(f"[prefix] {sp.ARCH} bf16: init {time.perf_counter() - t_phase:.1f} s")
    streams = {}
    counts, restore = _aliased_steps(Pool)

    def report(tag, m, wall, fleet, done):
        share, config = tag
        launches = check_stack_launches(torch, kmod, fleet.replicas,
                                        f"[prefix] {share} {config}", records,
                                        batched=fleet.last_batched_calls)
        aliased = sum(counts.pop(id(r.decode_pool), 0) for r in fleet.replicas)
        ps = m["prefix_stats"]
        print(f"[prefix] share={share} {config}: " + json.dumps({
            "completed": m["completed"], "hit_rate": m["hit_rate"],
            "shared_blocks": ps["shared_blocks"], "cow_splits": m["cow_splits"],
            "saved_prefill_j": m["saved_prefill_j"], "p99_ttft_s": m["p99_ttft_s"],
            "total_j": m["total_j"], "wall_s": wall,
            "decode_steps": {r.name: r.decode_stats.decode_steps for r in fleet.replicas},
            "graph_replays": {r.name: r.decode_pool.graph_replays for r in fleet.replicas},
            "launches": launches,
            "paged_decode_attention_over_aliased_tables": aliased * n_layers}))
        streams[tag] = [(r.prompt.tolist(), r.output) for r in done]
        zero_counts(torch, kmod)

    zero_counts(torch, kmod)
    try:
        for name, _, derived in sp.run(smoke=True, full_config=True, device="cuda",
                                       params_for={sp.ARCH: params}, on_run=report):
            print(f"[prefix] {name}: {derived}")
    except sp.RecipeViolation as e:
        for share in sp.SHARE_LEVELS:
            if all((share, c) in streams for c in sp.CONFIGS):
                at = _first_parting({c: streams[share, c] for c in sp.CONFIGS})
                if at:
                    print(f"[prefix] share={share}: streams first part at " + json.dumps(at))
        raise SystemExit(f"[prefix]: {'; '.join(e.violations)}")
    finally:
        restore()
    del params
    torch.cuda.empty_cache()
    print("[prefix] every claim of the recipe holds, bf16 streams equal across dense / "
          "paged / cow: ok")
    print(f"[prefix] phase done in {time.perf_counter() - t_phase:.1f} s")


EVENTS_REQUESTS = 256      # serve_events' wave trace, cut from 2000 (smoke) / 100 000


FOLD_KS = (4, 16, 64)      # group sizes of the fold measurement


def _median_ms(torch, fn, reps: int = 5) -> float:
    """Median CUDA-event ms of ``fn`` over ``reps`` calls."""
    ms = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    return sorted(ms)[reps // 2]


def fold_measurement(torch, cfg, params, ks=FOLD_KS, b=8, l=64, seed=5) -> dict:
    """The replica fold of a fused dense decode in ``cfg``'s dtype: K caches
    of B rows stepped as K member steps (what the tuple dispatch runs) and
    as ONE step folded to batch K x B (what a replica bank runs), on copies
    of the same random cache, lengths and tokens. The logits are compared
    bit for bit, and again with kernel 1's split plan pinned to the
    member's batch (``decode_attention(plan_batch=B)``, passed in for this
    measurement only), which leaves the GEMMs' shapes as the only
    difference. Timed (CUDA events, median of 5): both eagerly, and a
    bank's graph replay (``CacheBank`` of K members, captured as the
    engine captures it) against the K member graphs' replays back to back
    (K banks of one member: a pool's step and graph)."""
    from repro_torch.models import attention, decode_step, init_cache
    from repro_torch.serving import CacheBank

    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for k in ks:
        cache = _map(lambda t: (torch.randn(t.shape, generator=g, device="cuda") * 0.5)
                     .to(t.dtype), init_cache(cfg, k * b, l, device="cuda"))
        lengths = torch.randint(1, l - 1, (k * b,), generator=g, device="cuda",
                                dtype=torch.int32)
        tokens = torch.randint(1, cfg.vocab_size, (k * b,), generator=g, device="cuda",
                               dtype=torch.int32)
        members = [_map(lambda t, i=i: t[:, i * b:(i + 1) * b].clone(), cache)
                   for i in range(k)]

        def folded():
            return decode_step(params, cfg, tokens, cache, lengths)[0]

        def member_steps():
            return torch.cat([decode_step(params, cfg, tokens[i * b:(i + 1) * b], members[i],
                                          lengths[i * b:(i + 1) * b])[0] for i in range(k)])

        with torch.inference_mode():
            a, m = folded(), member_steps()
            kernel = attention.decode_attention
            attention.decode_attention = functools.partial(kernel, plan_batch=b)
            try:
                pinned = folded()
            finally:
                attention.decode_attention = kernel
            eager = {"folded": _median_ms(torch, folded),
                     "members": _median_ms(torch, member_steps)}
            banks = [CacheBank(cfg, params, k, b, l, device="cuda")] + [
                CacheBank(cfg, params, 1, b, l, device="cuda") for _ in range(k)]
            for dst, src in zip(_leaves(banks[0].tree), _leaves(cache)):
                dst.copy_(src)
            for bank, mem in zip(banks[1:], members):
                for dst, src in zip(_leaves(bank.tree), _leaves(mem)):
                    dst.copy_(src)
            toks, lens = tokens.cpu().numpy(), lengths.cpu().numpy()
            for i, bank in enumerate(banks):
                sl = slice(None) if i == 0 else slice((i - 1) * b, i * b)
                for _ in range(2):          # eager, then captured (and replayed)
                    bank.decode(toks[sl], lens[sl])
            graph = {"bank_replay": _median_ms(torch, banks[0]._graph.replay),
                     "member_replays": _median_ms(
                         torch, lambda: [bk._graph.replay() for bk in banks[1:]]),
                     "bank_capture_ms": banks[0].graph_capture_ms}
        diff, pdiff = (a - m).abs(), (pinned - m).abs()
        out[k] = {"bitwise_equal": bool(torch.equal(a, m)),
                  "max_abs_diff": diff.max().item(),
                  "rows_differing": int((diff.amax(-1) > 0).sum()), "rows": k * b,
                  "argmax_equal": bool(torch.equal(a.argmax(-1), m.argmax(-1))),
                  "pinned_plan_bitwise_equal": bool(torch.equal(pinned, m)),
                  "pinned_plan_max_abs_diff": pdiff.max().item(),
                  "pinned_plan_rows_differing": int((pdiff.amax(-1) > 0).sum()),
                  "folded_ms": eager["folded"], "member_steps_ms": eager["members"],
                  "bank_replay_ms": graph["bank_replay"],
                  "member_replays_ms": graph["member_replays"],
                  "bank_capture_ms": graph["bank_capture_ms"]}
        del cache, members, a, m, pinned, banks
    torch.cuda.empty_cache()
    return out


def events_phase(torch, kmod, records) -> None:
    """Phase 10, ``[events]``: ``serve_events``' fleet at full width (16 dense
    gemma-2b replicas on one weight set, lock, batch 8, ``max_seq_len`` 64,
    waves of 16 prompts of 16 tokens, 4 new tokens each; 32 pools on one
    card), through ``serve_events.run`` with the wave trace cut to
    ``EVENTS_REQUESTS`` requests: two replays (sha256 equal, fused decode
    covering >= 80 % of the steps), then the burst trace on the event
    engine and on the barrier (event p99 TTFT strictly lower). Each run's
    launch invariant across its pools and replica banks, ``EngineStats``,
    wall seconds, graph captures and replays are read as it ends
    (``on_run``). Then the fold measurement in bf16 (``fold_measurement``,
    K 4, 16 and 64 at L 64, and K 16 at L 1024, where kernel 1's split plan
    differs between a member's batch and the fold's)."""
    from repro_torch.benchmarks import serve_events as se
    from repro_torch.benchmarks.common import random_params
    from repro_torch.configs import get_config
    from repro_torch.serving import clear_program_caches

    t_phase = time.perf_counter()
    params = random_params(se.ARCH, full_config=True)
    torch.cuda.synchronize()

    def report(tag, m, wall, fleet):
        launches = check_stack_launches(torch, kmod, fleet.replicas, f"[events] {tag}", records,
                                        batched=fleet.last_batched_calls)
        st = fleet.last_engine_stats
        pools = [r.decode_pool for r in fleet.replicas]
        print(f"[events] {tag}: " + json.dumps({
            "completed": m["completed"], "p99_ttft_s": m["p99_ttft_s"], "wall_s": wall,
            "engine_stats": (st.as_dict() if st is not None else None),
            "graph_captures": sum(p._graph is not None for p in pools),
            "graph_replays": sum(p.graph_replays for p in pools),
            "capture_ms_mean": (sum(p.graph_capture_ms for p in pools)
                                / max(1, sum(p._graph is not None for p in pools))),
            "bank_steps": sum(p.bank_steps for p in pools), "banks": bank_report(fleet),
            "launches": launches}, default=float))
        zero_counts(torch, kmod)

    zero_counts(torch, kmod)
    for name, _, derived in se.run(smoke=True, full_config=True, device="cuda",
                                   params_for={se.ARCH: params}, n_requests=EVENTS_REQUESTS,
                                   on_run=report):
        print(f"[events] {name}: {derived}")
    print(f"[events] wave trace cut to {EVENTS_REQUESTS} requests (smoke 2000, full 100 000)")
    clear_program_caches()
    fold = fold_measurement(torch, get_config(se.ARCH), params)
    zero_counts(torch, kmod)          # the fold's launches are no run's
    for k, row in fold.items():
        print(f"[events] fold K={k} x B=8 (gemma-2b bf16, L 64): " + json.dumps(row))
    # at L 64 kernel 1 plans one split for a member and for the fold alike;
    # at L 1024 a member's rows split 16 ways and the fold's 2: the pinned
    # plan's row tells how much of the fold's difference that is
    for k, row in fold_measurement(torch, get_config(se.ARCH), params, ks=(16,),
                                   l=1024).items():
        print(f"[events] fold K={k} x B=8 (gemma-2b bf16, L 1024): " + json.dumps(row))
    zero_counts(torch, kmod)
    del params
    torch.cuda.empty_cache()
    print(f"[events] phase done in {time.perf_counter() - t_phase:.1f} s")


# [scale]'s request counts, cut from the recipe's smoke tier (4000 / 2000 /
# 1000, curve 1500 at g 4, 8, 32): the scale trace keeps its dispatch
# ceiling (1.474 dispatches a request at 1600, 1.51 at 1000 and 1.53 at
# 1200: the count is the reference's, the same on the CPU and the card);
# the aligned trace three whole waves of 100; the compare trace 100
# drifted requests (under 100 there is no aligned wave) and the curve one
# wave, the fewest each gate reads
SCALE_COUNTS = {"n_scale": 1600, "n_aligned": 300, "n_compare": 100, "n_curve": 100}
SCALE_SMOKE = {"n_scale": 4000, "n_aligned": 2000, "n_compare": 1000, "n_curve": 1500}


def scale_phase(torch, kmod, records) -> None:
    """Phase 11, ``[scale]``: ``serve_scale.run`` at full width in fp32 (the
    recipe's dtype; 88 gemma-2b + 12 minicpm-2b replicas on one weight set
    each, lock, batch 8, ``max_seq_len`` 64; 200 pools on one card), the
    recipe and gates ``python -m repro_torch.benchmarks.serve_scale --smoke
    --full-config`` runs, on ``SCALE_COUNTS``' cut traces: completion, two
    scale replays with equal sha256 and metrics, aligned fused decode
    coverage >= 80 %, dispatches below the serial pattern and under 1.5 a
    request, batched sha256 == tuple sha256 with batched decode calls,
    quantum 0 == the exact-tie engine and the positive quantum invariant,
    batched faster than tuple per fused call at g >= 8. Each replay's
    launch invariant across pools and banks, ``EngineStats``, wall seconds,
    bank steps, captures and replays are read as it ends (``on_run``). Then
    the fold measurement in fp32 (``fold_measurement``, gemma-2b). (An
    untimed bf16 batched-vs-tuple replay that ran here -- 12 of 100
    requests parted -- is cut for [mesh]'s time.)"""
    from repro_torch.benchmarks import serve_scale as ss
    from repro_torch.serving import clear_program_caches

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = ss.params_for_fleet(full_config=True, device="cuda")
    torch.cuda.synchronize()
    print(f"[scale] fp32 weights of {ss.ARCH_MAIN} and {ss.ARCH_ALT}: init "
          f"{time.perf_counter() - t_phase:.1f} s")

    def report(tag, m, wall, fleet):
        launches = check_stack_launches(torch, kmod, fleet.replicas, f"[scale] {tag}", records,
                                        batched=fleet.last_batched_calls)
        st = fleet.last_engine_stats
        pools = [r.decode_pool for r in fleet.replicas]
        print(f"[scale] {tag}: " + json.dumps({
            "requests": m["requests"], "completed": m.get("completed"), "wall_s": wall,
            "engine_stats": st.as_dict(),
            "pool_graph_captures": sum(p._graph is not None for p in pools),
            "pool_graph_replays": sum(p.graph_replays for p in pools),
            "bank_steps": sum(p.bank_steps for p in pools), "banks": bank_report(fleet),
            "launches": launches, "memory_allocated": torch.cuda.memory_allocated()},
            default=float))
        zero_counts(torch, kmod)

    zero_counts(torch, kmod)
    for name, _, derived in ss.run(smoke=True, full_config=True, device="cuda",
                                   params_for=params, on_run=report, **SCALE_COUNTS):
        print(f"[scale] {name}: {derived}")
    print(f"[scale] requests cut to {SCALE_COUNTS} (the recipe's smoke tier: {SCALE_SMOKE}); "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} bytes")
    clear_program_caches()
    fold = fold_measurement(torch, ss.config_for(ss.ARCH_MAIN, full_config=True),
                            params[ss.ARCH_MAIN])
    zero_counts(torch, kmod)          # the fold's launches are no run's
    for k, row in fold.items():
        print(f"[scale] fold K={k} x B=8 (gemma-2b fp32, L 64): " + json.dumps(row))
    del params
    torch.cuda.empty_cache()

    print(f"[scale] phase done in {time.perf_counter() - t_phase:.1f} s")


# phase 13, ``[train]``: full-width gemma-2b through ``run_training``
TRAIN_ARCH = "gemma-2b"
TRAIN_SHAPE = {"batch_size": 8, "seq_len": 512}     # loss chunk 512: the train step's default
TRAIN_STEPS = 20
TRAIN_SCHEDULE = (3e-4, 2, 12, 6)                   # wsd_schedule(peak, warmup, stable, decay)
# one batch, the same weights: remat off against on (loss, grad norm) and two
# microbatches against one (loss), relative
REMAT_RTOL = {"loss": 1e-3, "grad_norm": 1e-2}
MICROBATCH_RTOL = 1e-3
COMPRESSION_STEPS = 10
# forward's logits against prefill over FORWARD_TOKENS - 1 tokens and the
# decode step after it (kernel 1), at phase 4's bf16 tolerance for gemma-2b
FORWARD_TOKENS = 64
# the reduced fp32 restart: 3 steps, a checkpoint, a fresh state restored, 3
# more, against 6 straight; losses within this relative tolerance (bitwise
# equality is reported: the embedding backward accumulates with atomics)
RESTART_RTOL = 1e-5
# [train] item 5b: full-width bf16 prefill + decode steps of the archs the
# pool does not serve, kernel 1 against the plain path
FULL_WIDTH_SERVED_ELSEWHERE = ("llama-3.2-vision-11b", "musicgen-large")
FULL_WIDTH_SHAPE = {"batch": 2, "prompt": 128, "max_seq_len": 256, "steps": 3}
# item 6, the recurrent kinds at full width: (arch, batch, steps); the first
# through run_training, the others through make_train_step (gdn-4b at batch
# 4: its 4.26 B params hold ~51 GB in bf16 weights and grads and fp32
# moments before activations)
RECURRENT_TRAIN = (
    ("mamba2-780m", TRAIN_SHAPE, 10),
    ("gdn-4b", {"batch_size": 4, "seq_len": 512}, 3),
    ("zamba2-1.2b", TRAIN_SHAPE, 1),
)
RECURRENT_RUN_TRAINING = "mamba2-780m"
RECURRENT_SCHEDULE = (3e-4, 2, 5, 3)                 # wsd_schedule over 10 steps
# launches a recurrent layer and step: the forward scan twice (the forward
# and the remat recompute), its backward once
RECURRENT_LAUNCHES = (2, 1)


def _cuda_batch(torch, batch) -> dict:
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def check_no_launches(torch, kmod, what, want=None) -> dict:
    """Each counted wrapper's launches since the counts were last set to 0:
    ``want`` ({name: n}, the rest 0; default all 0), else the phase fails."""
    torch.cuda.synchronize()
    got = {name: getattr(kmod, name).launches for name in COUNTED}
    expect = {name: (want or {}).get(name, 0) for name in COUNTED}
    if got != expect:
        raise SystemExit(f"[train] {what}: kernel launches {got} != {expect}")
    return got


def train_phase(torch, kmod, records) -> None:
    """Phase 13, ``[train]``: the training path on the card.

    1. Full-width gemma-2b (bf16 params, fp32 moments) through
       ``run_training``: TRAIN_STEPS steps of TRAIN_SHAPE with
       TRAIN_SCHEDULE, remat per unit and the chunked loss; every loss
       finite and the mean of the last 5 below the first; at step 1 (the
       same weights and first batch) every parameter leaf's gradient finite
       and nonzero; step ms, tokens/s, the model-FLOP share of the bf16
       peak (6 N tokens / step time / 989e12) and peak memory.
    2. On one batch and the same weights: remat off against on
       (REMAT_RTOL), two microbatches against one (MICROBATCH_RTOL); after
       item 3, one train step profiled (device time by kernel), then
       COMPRESSION_STEPS steps with int8 compression from item 1's weights
       and batches: losses finite and falling, the error buffer finite.
    3. ``forward``'s logits at positions S-2 and S-1 (S = FORWARD_TOKENS)
       against ``prefill``'s last logits over the first S-1 tokens and the
       ``decode_step`` after it (kernel 1, launched once per layer), within
       LOGIT_ATOL_BF16.
    4. At reduced width, fp32: 3 steps, a checkpoint, a fresh state
       restored from it and 3 more, against 6 straight (RESTART_RTOL).
    5. One train step each of reduced llama-3.2-vision-11b (cross-attention)
       and musicgen-large (embedding inputs); then each at full width, bf16:
       a prefill and FULL_WIDTH_SHAPE's decode steps, kernel 1 against the
       plain path (``full_width_steps``).
    6. The recurrent kinds at full width (``recurrent_train``):
       mamba2-780m through ``run_training`` (RECURRENT_TRAIN: 10 steps of
       8 x 512, a finite nonzero gradient on every leaf at step 1, falling
       finite losses), gdn-4b (3 steps of 4 x 512) and zamba2-1.2b (one
       step of 8 x 512: N 64, the shared attention block under grad)
       through ``make_train_step``; step ms, tokens/s, peak memory and a
       profiled step's device ms by kernel.
    After item 2, the dry run's count of this train step (8 x 512) is held
    against the card: its argument bytes equal the card's state and batch;
    its FLOPs and temp estimate are printed beside the estimate and the
    peak of item 1.
    Items 1, 2, 4 and 5's reduced steps launch no decode or scan kernel;
    item 3 and item 5's full-width steps launch kernel 1 once per layer
    (and step), item 6 each recurrent layer's forward scan
    twice and its backward once a step (the forward, the remat recompute,
    the backward), all added to ``records``."""
    import tempfile

    from repro_torch.configs import ShapeSpec, get_config, reduced_config
    from repro_torch.kernels import cost
    from repro_torch.launch.dryrun import build_cell, storage_bytes
    from repro_torch.launch.train import run_training
    from repro_torch.models import decode_step, forward, init_cache, init_params, logits, prefill
    from repro_torch.training import (
        AdamW,
        DataConfig,
        PackedLMStream,
        global_norm,
        init_train_state,
        latest_step,
        make_train_step,
        restore_checkpoint,
        save_checkpoint,
        wsd_schedule,
    )
    from repro_torch.training import tree as T
    from repro_torch.training.train import value_and_grad

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    smi = nvidia_smi("name,power.limit")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    n_params = sum(t.numel() for t in T.leaves(params))
    batch = _cuda_batch(torch, PackedLMStream(cfg, DataConfig(seed=0, **TRAIN_SHAPE))
                        .next_batch())
    tokens = TRAIN_SHAPE["batch_size"] * TRAIN_SHAPE["seq_len"]

    # ---- 1. full width through run_training; the step-1 gradient first
    zero_counts(torch, kmod)
    loss0, grads = value_and_grad(params, cfg, batch)
    leaves = list(zip(T.paths(grads), T.leaves(grads)))
    bad = [p for p, g in leaves if not (bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0))]
    print(f"[train] {TRAIN_ARCH} step-1 gradient: {len(leaves) - len(bad)} of {len(leaves)} "
          f"parameter leaves finite and nonzero ({n_params / 1e9:.3f} B params), loss "
          f"{loss0.item():.4f}, grad norm {global_norm(grads).item():.4f}")
    if bad:
        raise SystemExit(f"[train] step-1 gradient zero or not finite on {bad}")
    del grads, leaves
    out = run_training(arch=TRAIN_ARCH, reduced=False, steps=TRAIN_STEPS, seed=0,
                       schedule=wsd_schedule(*TRAIN_SCHEDULE), params=params, device="cuda",
                       log_every=5, **TRAIN_SHAPE)
    check_no_launches(torch, kmod, "run_training")
    losses = out["losses"]
    step_s = out["step_ms"] / 1e3
    mfu = 6 * n_params * tokens / step_s / cost.PEAK_OPS["bfloat16"]
    print(f"[train] {TRAIN_ARCH} run_training ({smi}): " + json.dumps({
        "steps": out["steps"], "batch": TRAIN_SHAPE, "losses": losses,
        "step_ms": out["step_ms"], "tokens_per_s": tokens / step_s,
        "model_flop_share_of_bf16_peak": mfu, "peak_mem_gb": out["peak_mem_gb"],
        "wall_s": out["wall_s"], "straggler_events": out["straggler_events"]}))
    last5 = sum(losses[-5:]) / 5
    if not (all(math.isfinite(x) for x in losses) and last5 < losses[0]
            and abs(losses[0] - loss0.item()) <= 1e-3 * abs(loss0.item())):
        raise SystemExit(f"[train] losses not finite and falling (first {losses[0]}, mean of "
                         f"the last 5 {last5}, the step-1 check's {loss0.item()})")
    print(f"[train] losses finite, mean of the last 5 {last5:.4f} < first {losses[0]:.4f}: ok")

    # ---- 2. one batch, the same (trained) weights
    with torch.no_grad():
        want = {}
        for remat in (True, False):
            loss, grads = value_and_grad(params, cfg, batch, remat=remat)
            want[remat] = {"loss": loss.item(), "grad_norm": global_norm(grads).item()}
            del grads
        micro = {}
        for m in (1, 2):
            state = init_train_state(cfg, T.map(torch.clone, params), AdamW())
            if m == 1:
                card_arg_bytes = storage_bytes((state, batch))
            step = make_train_step(cfg, AdamW(), wsd_schedule(*TRAIN_SCHEDULE), microbatches=m)
            micro[m] = step(state, batch)[1]["loss"].item()
            del state, step
            torch.cuda.empty_cache()
    check_no_launches(torch, kmod, "remat / microbatch invariants")
    # the dry run's count of this train step against the state the card holds
    counter, meta = build_cell(TRAIN_ARCH, ShapeSpec("phase12_train", TRAIN_SHAPE["seq_len"],
                                                     TRAIN_SHAPE["batch_size"], "train"))
    print(f"[dryrun] {TRAIN_ARCH} train {TRAIN_SHAPE} vs the card: argument bytes dry run "
          f"{meta['argument_bytes']} / card (params, fp32 moments, count, step, batch) "
          f"{card_arg_bytes}; counted FLOPs {counter.flops:.4e} beside the estimate "
          f"{TRAIN_FLOPS_ESTIMATE:.1e} (PERF.md section 2), counted bytes {counter.bytes:.4e}; "
          f"arguments + temp estimate {(meta['argument_bytes'] + counter.peak_bytes) / 1e9:.2f} "
          f"GB beside run_training's peak {out['peak_mem_gb']:.2f} GB (printed, not asserted)")
    if meta["argument_bytes"] != card_arg_bytes:
        raise SystemExit("[dryrun] the dry run's train argument bytes differ from the card's")
    del counter, meta
    rel = lambda a, b: abs(a - b) / abs(b)
    inv = {"remat_on": want[True], "remat_off": want[False], "loss_microbatches_1": micro[1],
           "loss_microbatches_2": micro[2],
           "remat_rel": {k: rel(want[False][k], want[True][k]) for k in REMAT_RTOL},
           "microbatch_rel": rel(micro[2], micro[1])}
    print(f"[train] invariants on one batch: " + json.dumps(inv)
          + f" (remat off vs on within {REMAT_RTOL}, 2 vs 1 microbatches within "
          f"{MICROBATCH_RTOL}, relative)")
    if not (all(inv["remat_rel"][k] <= tol for k, tol in REMAT_RTOL.items())
            and inv["microbatch_rel"] <= MICROBATCH_RTOL):
        raise SystemExit("[train] remat or microbatch invariant broken")

    # ---- 3. the training forward against the served path (kernel 1)
    toks = batch["inputs"][:, :FORWARD_TOKENS]
    b = toks.shape[0]
    with torch.no_grad():
        lg = logits(params, cfg, forward(params, cfg, toks)[:, -2:])
        cache = init_cache(cfg, b, FORWARD_TOKENS, device="cuda")
        zero_counts(torch, kmod)
        lp, cache, ln = prefill(params, cfg, toks[:, :-1], cache)
        ld, cache, ln = decode_step(params, cfg, toks[:, -1], cache, ln)
    n_attn = _n_layers(cfg, "decode")
    got = check_no_launches(torch, kmod, "forward vs served path",
                            {"decode_attention": n_attn,
                             "prefill_attention": _n_layers(cfg, "prefill_attn")})
    for name in ("decode_attention", "prefill_attention"):
        records[name]["launches"] += got[name]
    err = {"prefill": (lp - lg[:, 0]).abs().max().item(),
           "decode_step": (ld - lg[:, 1]).abs().max().item(),
           "max_logit": lg.abs().max().item(),
           "argmax_equal": [bool((lp.argmax(-1) == lg[:, 0].argmax(-1)).all()),
                            bool((ld.argmax(-1) == lg[:, 1].argmax(-1)).all())]}
    atol = LOGIT_ATOL_BF16[TRAIN_ARCH]
    print(f"[train] forward vs prefill / decode_step logits (B {b}, S {FORWARD_TOKENS}, bf16; "
          f"kernel 1 launched {got['decode_attention']} = {n_attn} layers x 1 step): "
          + json.dumps(err) + f" (atol {atol})")
    if not max(err["prefill"], err["decode_step"]) <= atol:
        raise SystemExit("[train] forward disagrees with prefill / decode_step")
    del cache, lg, lp, ld

    # ---- 1b. where a step's time goes: one profiled step on fresh weights
    del params, batch
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    stream = PackedLMStream(cfg, DataConfig(seed=1, **TRAIN_SHAPE))
    step = make_train_step(cfg, AdamW(), wsd_schedule(*TRAIN_SCHEDULE))
    state = init_train_state(cfg, params, AdamW())
    zero_counts(torch, kmod)
    state, _ = step(state, _cuda_batch(torch, stream.next_batch()))      # warm-up
    pbatch = _cuda_batch(torch, stream.next_batch())
    rows, wall, attempts, timeline = profiled(torch, lambda: step(state, pbatch), 1)
    check_no_launches(torch, kmod, "profiled step")
    print(f"[train] one profiled step ({smi}): " + json.dumps({
        "wall_ms": wall, "device_busy_ms": sum(r[0] for r in rows), "attempts": attempts,
        **timeline, "kernels": sum(r[1] for r in rows),
        "top": [{"kernel": k[:90], "ms": ms, "calls": c} for ms, c, k in rows[:PROFILE_ROWS]]}))
    del state, step, params, pbatch
    torch.cuda.empty_cache()

    # ---- 2b. int8 compression with error feedback, from item 1's weights and batches
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    zero_counts(torch, kmod)
    step = make_train_step(cfg, AdamW(), wsd_schedule(*TRAIN_SCHEDULE), compression=True)
    state = init_train_state(cfg, params, AdamW(), compression=True)
    stream = PackedLMStream(cfg, DataConfig(seed=0, **TRAIN_SHAPE))
    closses = []
    for _ in range(COMPRESSION_STEPS):
        state, metrics = step(state, _cuda_batch(torch, stream.next_batch()))
        closses.append(metrics["loss"].item())
    err_finite = all(bool(torch.isfinite(e).all()) for e in T.leaves(state.error_buf))
    check_no_launches(torch, kmod, "compression")
    print(f"[train] int8 compression, {COMPRESSION_STEPS} steps from item 1's weights and "
          f"batches: losses {closses} (uncompressed {losses[:COMPRESSION_STEPS]}), error buffer "
          f"finite {err_finite}")
    if not (all(math.isfinite(x) for x in closses) and closses[-1] < closses[0] and err_finite):
        raise SystemExit("[train] compressed training: losses not finite and falling, or the "
                         "error buffer not finite")
    del state, step, params
    torch.cuda.empty_cache()

    # ---- 4. restart from a checkpoint, reduced width, fp32
    rcfg = reduced_config(TRAIN_ARCH)
    rstep = make_train_step(rcfg, AdamW(), wsd_schedule(*TRAIN_SCHEDULE))
    rstream = PackedLMStream(rcfg, DataConfig(seq_len=64, batch_size=8, seed=0))
    rbatches = [_cuda_batch(torch, rstream.next_batch()) for _ in range(6)]

    def fresh(seed):
        p = init_params(rcfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
        return init_train_state(rcfg, p, AdamW())

    def run(state, bs):
        out = []
        for bt in bs:
            state, m = rstep(state, bt)
            out.append(m["loss"].item())
        return state, out

    zero_counts(torch, kmod)
    straight, s_losses = run(fresh(0), rbatches)
    with tempfile.TemporaryDirectory() as d:
        half, r_losses = run(fresh(0), rbatches[:3])
        save_checkpoint(d, 3, half)
        restored = restore_checkpoint(d, latest_step(d), fresh(1))
        resumed, more = run(restored, rbatches[3:])
    r_losses += more
    check_no_launches(torch, kmod, "restart")
    bitwise = s_losses == r_losses
    param_diff = max((a - b).abs().max().item()
                     for a, b in zip(T.leaves(straight.params), T.leaves(resumed.params)))
    print(f"[train] restart ({TRAIN_ARCH} reduced, fp32): straight {s_losses}, restored at 3 "
          f"{r_losses}; bitwise equal {bitwise}, params max |diff| {param_diff:.3e} (losses "
          f"within {RESTART_RTOL} relative)")
    if not (int(resumed.step) == 6 and all(abs(a - b) <= RESTART_RTOL * abs(a)
                                           for a, b in zip(s_losses, r_losses))):
        raise SystemExit("[train] the restored run parts from the straight run")

    # ---- 5. cross-attention and embedding inputs, reduced, one step each
    for arch in ("llama-3.2-vision-11b", "musicgen-large"):
        xcfg = reduced_config(arch)
        p = init_params(xcfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        state = init_train_state(xcfg, p, AdamW())
        xb = _cuda_batch(torch, PackedLMStream(xcfg, DataConfig(seq_len=32, batch_size=4))
                         .next_batch())
        state, m = make_train_step(xcfg, AdamW(), wsd_schedule(*TRAIN_SCHEDULE))(state, xb)
        ok = (math.isfinite(m["loss"].item()) and 0 < m["grad_norm"].item() < float("inf")
              and all(bool(torch.isfinite(t).all()) for t in T.leaves(state.params)))
        print(f"[train] {arch} reduced one step ({', '.join(sorted(xb))}): loss "
              f"{m['loss'].item():.4f}, grad norm {m['grad_norm'].item():.4f}, params finite "
              f"{ok}")
        if not ok:
            raise SystemExit(f"[train] {arch}: the train step gave a non-finite result")
    check_no_launches(torch, kmod, "cross_attn / embedding steps")
    for arch in FULL_WIDTH_SERVED_ELSEWHERE:
        full_width_steps(torch, kmod, records, arch)

    # ---- 6. the recurrent kinds at full width: kernels 3 and 6, forward and backward
    for arch, shape, steps in RECURRENT_TRAIN:
        recurrent_train(torch, kmod, records, arch, shape, steps, smi)
    print(f"[train] phase done in {time.perf_counter() - t_phase:.1f} s")


def full_width_steps(torch, kmod, records, arch) -> None:
    """[train] item 5b: full-width bf16 ``prefill`` and FULL_WIDTH_STEPS
    ``decode_step``s of a model the pool does not serve (cross-attention to
    encoder states, or embedding inputs), batch and lengths as
    FULL_WIDTH_SHAPE: each decode step through kernel 1 against the plain
    path on a copy of the same cache, logits finite, of shape (B, vocab) and
    within the model's LOGIT_ATOL_BF16; kernel 1 launched once per
    self-attention layer and step (``cross_attn`` layers read their cached
    encoder k/v, no kernel), every other kernel never; the launches added
    to ``records``."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, init_params, prefill

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    b, s, max_len, steps = (FULL_WIDTH_SHAPE[k] for k in ("batch", "prompt", "max_seq_len",
                                                          "steps"))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    g = torch.Generator(device="cuda").manual_seed(1)
    cd = getattr(torch, cfg.compute_dtype)
    rand = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(cd)
    if cfg.input_is_embeddings:
        inputs, rows = rand(b, s, cfg.d_model), [rand(b, 1, cfg.d_model) for _ in range(steps)]
    else:
        inputs = torch.randint(1, cfg.vocab_size, (b, s), generator=g, device="cuda")
    enc = rand(b, cfg.n_media_tokens, cfg.d_model) if cfg.n_media_tokens else None
    zero_counts(torch, kmod)
    errs, finite = [], True
    with torch.no_grad():
        cache = init_cache(cfg, b, max_len, device="cuda")
        lg, cache, ln = prefill(params, cfg, inputs, cache, enc_states=enc)
        finite &= bool(torch.isfinite(lg).all()) and tuple(lg.shape) == (b, cfg.vocab_size)
        plain_cache = _map(torch.clone, cache)
        ln_plain = ln
        for i in range(steps):
            x = rows[i] if cfg.input_is_embeddings else lg.argmax(-1).to(torch.int32)
            lg, cache, ln = decode_step(params, cfg, x, cache, ln)
            lp, plain_cache, ln_plain = decode_step(params, cfg, x, plain_cache, ln_plain,
                                                    plain=True)
            finite &= bool(torch.isfinite(lg).all()) and tuple(lg.shape) == (b, cfg.vocab_size)
            errs.append((lg.float() - lp.float()).abs().max().item())
    n_attn = _n_layers(cfg, "decode")
    got = check_no_launches(torch, kmod, f"{arch} full-width steps",
                            {"decode_attention": n_attn * steps,
                             "prefill_attention": _n_layers(cfg, "prefill_attn")})
    for name in ("decode_attention", "prefill_attention"):
        records[name]["launches"] += got[name]
    atol = LOGIT_ATOL_BF16[arch]
    print(f"[train] {arch} full width bf16 ({n_params / 1e9:.3f} B params; "
          f"{'embedding inputs' if cfg.input_is_embeddings else 'token ids'}"
          f"{f', {cfg.n_media_tokens} encoder states' if enc is not None else ''}): prefill B "
          f"{b} x {s} then {steps} decode steps, kernel vs plain max |dlogit| a step "
          f"{[float(f'{e:.4f}') for e in errs]} (atol {atol}), logits finite {finite}; kernel 1 "
          f"launched {got['decode_attention']} = {n_attn} self-attention layers x {steps}; "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
          f"{time.perf_counter() - t0:.1f} s")
    if not (finite and max(errs) <= atol):
        raise SystemExit(f"[train] {arch}: full-width kernel-path logits disagree with the plain "
                         "path, or are not finite")
    del params, cache, plain_cache, lg, lp
    torch.cuda.empty_cache()


def recurrent_train(torch, kmod, records, arch, shape, steps, smi) -> None:
    """[train] item 6 for one recurrent arch at full width, bf16 params:
    ``steps`` train steps of ``shape`` (RECURRENT_RUN_TRAINING through
    ``run_training``, after a step-1 gradient whose every leaf must be
    finite and nonzero, the losses finite and the mean of the last 3 below
    the first; the others through ``make_train_step``, the losses finite),
    then one profiled step. Each run launches the arch's forward scan twice
    per recurrent layer and step (the forward and the remat recompute) and
    its backward once (RECURRENT_LAUNCHES), every other kernel never; the
    launches are added to ``records``. Prints step ms, tokens/s, peak
    memory and the profiled step's device ms by kernel."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run_training
    from repro_torch.models import init_params
    from repro_torch.training import (
        AdamW,
        DataConfig,
        PackedLMStream,
        global_norm,
        init_train_state,
        make_train_step,
        wsd_schedule,
    )
    from repro_torch.training import tree as T
    from repro_torch.training.train import value_and_grad

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    fwd = KERNELS_OF[arch]["prefill"][0]      # the scan
    layers = _n_layers(cfg, "scan")
    want = lambda n: {fwd: RECURRENT_LAUNCHES[0] * layers * n,
                      f"{fwd}_bwd": RECURRENT_LAUNCHES[1] * layers * n}

    def count(what, n):
        for name, k in check_no_launches(torch, kmod, f"{arch} {what}", want(n)).items():
            records[name]["launches"] += k

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    n_params = sum(t.numel() for t in T.leaves(params))
    stream = PackedLMStream(cfg, DataConfig(seed=0, **shape))
    tokens = shape["batch_size"] * shape["seq_len"]
    sched = wsd_schedule(*RECURRENT_SCHEDULE)
    row = {"arch": arch, "params_b": n_params / 1e9, "recurrent_layers": layers, "batch": shape}
    if arch == RECURRENT_RUN_TRAINING:
        batch = _cuda_batch(torch, PackedLMStream(cfg, DataConfig(seed=0, **shape))
                            .next_batch())
        zero_counts(torch, kmod)
        loss0, grads = value_and_grad(params, cfg, batch)
        count("step-1 gradient", 1)
        leaves = list(zip(T.paths(grads), T.leaves(grads)))
        bad = [p for p, g in leaves
               if not (bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0))]
        print(f"[train] {arch} step-1 gradient: {len(leaves) - len(bad)} of {len(leaves)} "
              f"parameter leaves finite and nonzero, loss {loss0.item():.4f}, grad norm "
              f"{global_norm(grads).item():.4f}")
        if bad:
            raise SystemExit(f"[train] {arch}: step-1 gradient zero or not finite on {bad}")
        del grads, leaves, batch
        zero_counts(torch, kmod)
        out = run_training(arch=arch, reduced=False, steps=steps, seed=0, schedule=sched,
                           params=params, device="cuda", log_every=5, **shape)
        count("run_training", steps)
        losses, step_ms, peak = out["losses"], out["step_ms"], out["peak_mem_gb"]
        last = sum(losses[-3:]) / 3
        if not (all(math.isfinite(x) for x in losses) and last < losses[0]):
            raise SystemExit(f"[train] {arch}: losses not finite and falling ({losses})")
        stream = PackedLMStream(cfg, DataConfig(seed=0, **shape))    # the profile's batch
        step = make_train_step(cfg, AdamW(), sched)
        state = init_train_state(cfg, params, AdamW())
    else:
        step = make_train_step(cfg, AdamW(), sched)
        state = init_train_state(cfg, params, AdamW())
        torch.cuda.reset_peak_memory_stats()
        zero_counts(torch, kmod)
        losses, times, norms = [], [], []
        for _ in range(steps):
            b = _cuda_batch(torch, stream.next_batch())
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step(state, b)
            losses.append(m["loss"].item())
            times.append((time.perf_counter() - t1) * 1e3)
            norms.append(m["grad_norm"].item())
        count("train steps", steps)
        step_ms = sum(times[1:]) / len(times[1:]) if steps > 1 else times[0]
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not (all(math.isfinite(x) for x in losses)
                and all(0 < g < float("inf") for g in norms)):
            raise SystemExit(f"[train] {arch}: losses {losses} / grad norms {norms} not finite")
        row["grad_norms"] = norms
    row.update({"steps": steps, "losses": losses, "step_ms": step_ms,
                "tokens_per_s": tokens / (step_ms / 1e3), "peak_mem_gb": peak})
    pbatch = _cuda_batch(torch, stream.next_batch())
    zero_counts(torch, kmod)
    rows, wall, attempts, timeline = profiled(torch, lambda: step(state, pbatch), 1)
    count("profiled step", 1)
    scans = {k: ms for ms, _, k in rows if "ssd_" in k or "gdn_" in k}
    row["profiled_step"] = {
        "wall_ms": wall, "device_busy_ms": sum(r[0] for r in rows), "attempts": attempts,
        **timeline, "kernels": sum(r[1] for r in rows), "scan_kernels_ms": scans,
        "top": [{"kernel": k[:90], "ms": ms, "calls": c} for ms, c, k in rows[:PROFILE_ROWS]]}
    print(f"[train] {arch} full width ({smi}): " + json.dumps(row))
    print(f"[train] {arch}: {steps} steps, losses finite, {fwd} x {want(1)[fwd]} and "
          f"{fwd}_bwd x {want(1)[fwd + '_bwd']} a step, {time.perf_counter() - t0:.1f} s: ok")
    del state, step, params
    torch.cuda.empty_cache()


# the verdicts ``[paper]`` asserts: driver -> substrings of its ``derived``
# the dry run's sweep: every ASSIGNED_ARCHS x ALL_SHAPES cell, 32 applicable
DRYRUN_RECORDS, DRYRUN_OK = 40, 32
DRYRUN_TIMEOUT_S = 400
# the cells held against the card: phase 4's gemma-2b decode step (B 8, a
# cache of 1024) and phase 13's train step (8 x 512)
DRYRUN_DECODE = ("gemma-2b", 8, 1024)
TRAIN_FLOPS_ESTIMATE = 8.2e13            # PERF.md section 2's gemma-2b step estimate


class DryRunProcess:
    """The one-card dry run of every cell (``python -m
    repro_torch.launch.dryrun``) on the CPU, in a process of its own started
    with the run, so that its tracing overlaps the card's phases;
    ``finish`` waits for it and checks its records, ``stop`` ends it if it
    still runs and removes its files."""

    def __init__(self, args=()):
        import os
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="dryrun_")
        self.cells = str(Path(self.dir, "cells"))
        self.log_path = Path(self.dir, "log.txt")
        self.t0 = time.perf_counter()
        self.log = open(self.log_path, "w")
        env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", self.cells, *args],
            stdout=self.log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))

    def finish(self) -> str:
        """Wait for the sweep, print its lines, check 40 records (32 ok, 8
        skipped) -> the directory of its cells."""
        t_wait = time.perf_counter()
        rc = self.proc.wait(timeout=DRYRUN_TIMEOUT_S)
        self.log.close()
        waited = time.perf_counter() - t_wait
        for line in self.log_path.read_text().splitlines():
            print(f"[dryrun] {line}")
        recs = [json.loads(p.read_text()) for p in sorted(Path(self.cells).glob("*.json"))]
        n_ok = sum(1 for r in recs if r.get("ok"))
        n_skip = sum(1 for r in recs if not r["applicable"])
        traced = sum(r.get("t_trace_s", 0.0) for r in recs)
        print(f"[dryrun] {len(recs)} records: {n_ok} ok, {n_skip} skipped; exit code {rc}; "
              f"{traced:.1f} s of tracing in its own process, beside the card phases; "
              f"[paper] waited {waited:.1f} s for it, {t_wait - self.t0:.1f} s after it started")
        if rc != 0 or (len(recs), n_ok, n_skip) != (DRYRUN_RECORDS, DRYRUN_OK,
                                                     DRYRUN_RECORDS - DRYRUN_OK):
            raise SystemExit("[dryrun] the sweep failed or wrote the wrong records")
        return self.cells

    def stop(self) -> None:
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


# the pod dry run [mesh] reads: the reference probe's four cells and
# gemma-2b's train step, on the 16 x 16 and 2 x 16 x 16 meshes
POD_CELLS = (("gemma-2b", "decode_32k"), ("deepseek-v2-lite-16b", "decode_32k"),
             ("mamba2-780m", "long_500k"), ("minicpm-2b", "train_4k"), ("gemma-2b", "train_4k"))
POD_TIMEOUT_S = 600


class PodDryRunProcess(DryRunProcess):
    """``POD_CELLS`` on both pod meshes (``python -m repro_torch.launch.dryrun
    --both-meshes --cells ...``: meta DTensors over a fake process group of
    256 / 512 ranks) on the CPU, in a process of its own started with the
    run; ``finish`` waits for it and prints one line a cell."""

    def __init__(self):
        super().__init__(["--both-meshes", "--cells", *(f"{a}:{c}" for a, c in POD_CELLS)])

    def finish(self) -> list:
        t_wait = time.perf_counter()
        rc = self.proc.wait(timeout=POD_TIMEOUT_S)
        self.log.close()
        waited = time.perf_counter() - t_wait
        recs = [json.loads(p.read_text()) for p in sorted(Path(self.cells).glob("*.json"))]
        for r in recs:
            if not r.get("ok"):
                print(f"[mesh] pod cell {r['arch']} {r['shape']} {r['mesh']}: "
                      f"{r.get('error')}\n{r.get('traceback', '')}")
                continue
            ma = r["memory_analysis"]
            print(f"[mesh] pod {r['arch']} {r['shape']} {r['mesh']} (fsdp {r['fsdp']}): "
                  f"flops/device {r['hlo_flops_per_device']:.4e}, bytes/device "
                  f"{r['hlo_bytes_per_device']:.4e}, argument GB "
                  f"{ma['argument_size_in_bytes'] / 1e9:.4f}, collectives "
                  f"{r['collective_bytes_per_device'] / 1e6:.3f} MB "
                  f"{json.dumps(r['collective_count_by_op'], sort_keys=True)} MB by op "
                  f"{json.dumps({k: round(v / 1e6, 3) for k, v in sorted(r['collective_bytes_by_op'].items())})}"
                  f"; local_map {r['local_map_sites']}; traced {r['t_trace_s']} s")
        traced = sum(r.get("t_trace_s", 0.0) for r in recs)
        print(f"[mesh] pod dry run: {len(recs)} records, exit code {rc}, {traced:.1f} s of "
              f"tracing beside the card phases; waited {waited:.1f} s for it")
        if rc != 0 or len(recs) != 2 * len(POD_CELLS) or not all(r.get("ok") for r in recs):
            raise SystemExit("[mesh] the pod dry run failed or wrote the wrong records")
        return recs


def dryrun_card_check(torch, kmod, records) -> None:
    """The dry run held against the card on DRYRUN_DECODE's decode cell:
    its argument bytes equal the bytes of the params, cache, token and
    lengths the card holds for the same step, and its counted kernel-1
    calls equal the launches the card counts for one ``decode_step``
    (added to ``records``); the counted temp estimate printed beside the
    step's ``max_memory_allocated`` above its arguments (not asserted)."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.dryrun import build_cell, storage_bytes
    from repro_torch.models import decode_step, init_cache, init_params

    arch, b, l = DRYRUN_DECODE
    cfg = get_config(arch)
    counter, meta = build_cell(arch, ShapeSpec("phase4_decode", l, b, "decode"))
    calls = {k: v["calls"] for k, v in counter.kernels.items()}
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    cache = init_cache(cfg, b, l, device="cuda")
    token = torch.randint(1, cfg.vocab_size, (b,), dtype=torch.int32, device="cuda")
    lengths = torch.full((b,), l // 2, dtype=torch.int32, device="cuda")
    args = {"params": params, "token": token, "cache": cache, "lengths": lengths}
    card_bytes = storage_bytes(args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_counts(torch, kmod)
    with torch.no_grad():
        lg, _, _ = decode_step(params, cfg, token, cache, lengths)
    got = check_no_launches(torch, kmod, "dry run vs card decode step",
                            {"decode_attention": calls.get("decode_attention", -1)})
    records["decode_attention"]["launches"] += got["decode_attention"]
    peak = torch.cuda.max_memory_allocated() - base
    print(f"[dryrun] {arch} decode B {b} L {l} vs the card: argument bytes dry run "
          f"{meta['argument_bytes']} / card {card_bytes}; kernel calls counted {calls} / card "
          f"launches of one decode_step {got['decode_attention']}; temp estimate "
          f"{counter.peak_bytes} bytes beside the card's max_memory_allocated above the "
          f"arguments {peak} bytes (printed, not asserted); counted FLOPs {counter.flops:.4e}, "
          f"bytes {counter.bytes:.4e}")
    if meta["argument_bytes"] != card_bytes or not bool(torch.isfinite(lg).all()):
        raise SystemExit("[dryrun] the dry run's argument bytes differ from the card's")
    del params, cache, lg
    torch.cuda.empty_cache()


PAPER_VERDICTS = {
    "roofline_report": ("single_pod_cells=0;multi_pod_cells=0;one_card_cells=32;",),
    "table1_power_cap": ("actual_clock_always=1830MHz", "any_cap_engaged=False"),
    "fig1_roofline": ("all_decode_memory_bound=True",),
    "fig3_pareto": ("lock_dominates_all=True;configs_checked=10",),
    "hypotheses": ("confirmed=4;qualified=2",),
    "tpu_native": ("any_cap_engaged=True;savings_min=23.6%;savings_max=29.3%",),
}
# the card's own clock and power surface, printed beside H100_SXM's fields
SMI_SURFACE = "name,power.limit,power.min_limit,power.max_limit,clocks.max.sm"


def supported_graphics_clocks() -> list:
    """The graphics clocks ``nvidia-smi`` lists as supported (MHz, over
    every memory clock), highest first; an entry it cannot read (``[N/A]``)
    is kept as it prints it."""
    out = subprocess.run(["nvidia-smi", "--query-supported-clocks=gr",
                          "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True).stdout.split()
    nums = sorted({int(x) for x in out if x.isdigit()}, reverse=True)
    return nums + sorted({x for x in out if not x.isdigit()})


def paper_phase(torch, kmod, records, dry) -> None:
    """Phase 12, ``[paper]``: every analytic table and figure driver of
    ``repro_torch.benchmarks`` through its ``run`` (CSVs into a temporary
    directory), the recipes' verdicts asserted (``PAPER_VERDICTS``), with
    ``roofline_report`` reading the one-card dry run's cells (``dry``, a
    ``DryRunProcess``, started with the run): 40
    records, 32 ok and 8 skipped, and the report's one-card table of 32
    cells; the dry run held against the card (``dryrun_card_check``);
    ``tpu_native.run(chip="h100-sxm")``'s rows printed; ``kernels_micro.run``
    on the card (four fp32 kernels held against their plain versions at
    5e-5 / 2e-4, timed with CUDA events), each counted wrapper's launches
    checked against ``kernels_micro.LAUNCHES`` and added to ``records``; the
    card's clock and power surface beside ``H100_SXM``'s fields."""
    import os
    import tempfile

    from repro_torch.benchmarks import (
        fig1_roofline,
        fig2_heatmaps,
        fig3_pareto,
        fig4_request_energy,
        hypotheses_bench,
        kernels_micro,
        policy_bench,
        roofline_report,
        table1_power_cap,
        tpu_native,
    )
    from repro_torch.hw import H100_SXM

    t_phase = time.perf_counter()
    cells_dir = dry.finish()
    os.environ["REPRO_DRYRUN_OUT"] = cells_dir
    with tempfile.TemporaryDirectory() as out:
        os.environ["REPRO_BENCH_OUT"] = out
        for mod in (table1_power_cap, fig1_roofline, fig2_heatmaps, fig3_pareto,
                    fig4_request_energy, hypotheses_bench, policy_bench, tpu_native,
                    roofline_report):
            for name, us, derived in mod.run():
                print(f"[paper] {name}: {derived} ({us:.0f} us host)")
                for verdict in PAPER_VERDICTS.get(name, ()):
                    if verdict not in derived:
                        raise SystemExit(f"[paper] {name}: {verdict!r} not in {derived!r}")
        for line in Path(out, "roofline.md").read_text().splitlines():
            if "| h100x1 |" in line:
                print(f"[paper] roofline.md {line}")
        del os.environ["REPRO_DRYRUN_OUT"]
        dryrun_card_check(torch, kmod, records)
        [(name, _, derived)] = tpu_native.run(chip="h100-sxm")
        print(f"[paper] {name} (H100_SXM model): {derived}")
        for line in Path(out, "h100_native.csv").read_text().splitlines():
            print(f"[paper] h100_native.csv {line}")

        zero_counts(torch, kmod)
        rows = kernels_micro.run(device="cuda")
        torch.cuda.synchronize()
        del os.environ["REPRO_BENCH_OUT"]
    got = {name: getattr(kmod, name).launches for name in COUNTED}
    want = dict.fromkeys(COUNTED, 0)
    for _, _, _, counted, _ in kernels_micro.KERNELS.values():
        want[counted] = kernels_micro.LAUNCHES
    if got != want:
        raise SystemExit(f"[paper] kernels_micro: launches {got} != {want}")
    for name, n in got.items():
        records[name]["launches"] += n
    for name, us, derived in rows:
        fields = dict(kv.split("=", 1) for kv in derived.split(";") if "=" in kv)
        if fields["ran"] != "cuda" or not float(fields["max_abs_err"]) <= float(fields["tol"]):
            raise SystemExit(f"[paper] {name}: {derived}")
        print(f"[paper] kernels_micro {name}: kernel {us:.3f} us, plain {fields['ref_us']} us "
              f"(CUDA events, {kernels_micro.ITERS} calls after {kernels_micro.WARMUP}); "
              f"{derived}")

    print(f"[paper] card ({SMI_SURFACE}): {nvidia_smi(SMI_SURFACE)}")
    clocks = supported_graphics_clocks()
    print(f"[paper] card supported graphics clocks (MHz), {len(clocks)}: {clocks}")
    spec = dataclasses.asdict(H100_SXM)
    print("[paper] H100_SXM (data sheet: peak_flops_bf16, peak_flops_vpu, hbm_bw, "
          "hbm_capacity, ici_bw, ici_links, tdp; the rest assumed from H200_SXM): "
          + json.dumps({k: (list(v) if isinstance(v, tuple) else v) for k, v in spec.items()}))
    print(f"[paper] phase done in {time.perf_counter() - t_phase:.1f} s")


def examples_phase(torch, kmod) -> None:
    """Phase 14, ``[examples]``: the port's examples and scripts on the card
    at their own sizes, through their ``main``: ``characterize_paper`` and
    ``calibrate`` (analytic), ``quickstart`` (reduced gemma-2b: 20 train
    steps, 6 served requests; losses finite), ``serve_decode_pool`` (reduced
    minicpm-2b, three controller modes: the cap never engaged on decode,
    the lock saving more than 20 %), ``train_wsd`` (60 steps of the ~25 M
    model, checkpoints in a temporary directory) and ``smoke_models``
    (every block kind's tiny config, fp32, prefill + decode through the
    kernels against the training forward at 2e-4). Their launches are
    printed, not added to the kernels' line: this is not the main path."""
    import contextlib
    import io
    import tempfile

    from repro_torch.examples import characterize_paper, quickstart, serve_decode_pool, train_wsd
    from repro_torch.scripts import calibrate, smoke_models

    t_phase = time.perf_counter()

    def run(name, fn):
        t0 = time.perf_counter()
        buf = io.StringIO()
        zero_counts(torch, kmod)
        with contextlib.redirect_stdout(buf):
            out = fn()
        torch.cuda.synchronize()
        launches = {k: getattr(kmod, k).launches for k in COUNTED if getattr(kmod, k).launches}
        lines = buf.getvalue().splitlines()
        for line in lines[-6:]:
            print(f"[examples] {name} | {line}")
        print(f"[examples] {name}: {len(lines)} lines, {time.perf_counter() - t0:.1f} s, "
              f"launches {launches}")
        return out

    run("characterize_paper", characterize_paper.main)
    run("calibrate", calibrate.main)
    q = run("quickstart", lambda: quickstart.main(["--device", "cuda"]))
    if not (math.isfinite(q["report"]["last_loss"]) and q["completed"] == 6):
        raise SystemExit(f"[examples] quickstart: {q['report']}, {q['completed']} completed")
    res = run("serve_decode_pool", lambda: serve_decode_pool.main(["--device", "cuda"]))
    if res["cap"]["decode_engaged"] or not res["lock"]["savings_pct"] > 20.0:
        raise SystemExit(f"[examples] serve_decode_pool: the cap engaged on decode or the lock "
                         f"saved {res['lock']['savings_pct']:.1f} %")
    with tempfile.TemporaryDirectory() as d:
        w = run("train_wsd", lambda: train_wsd.main(["--device", "cuda", "--ckpt-dir", d]))
    if len(w["losses"]) != 60 or not all(math.isfinite(x) for x in w["losses"]):
        raise SystemExit(f"[examples] train_wsd: losses {w['losses']}")
    run("smoke_models", lambda: smoke_models.main(["--device", "cuda"]))
    print(f"[examples] phase done in {time.perf_counter() - t_phase:.1f} s")


MESH_ARCH = "gemma-2b"
MESH_SHAPE = {"batch": 8, "max_seq_len": 1024, "new": 32}   # phase 4's decode


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _greedy(torch, kmod, cfg, params, prompts, place) -> dict:
    """Prefill ``prompts`` (padded into one batch) and MESH_SHAPE["new"]
    greedy decode steps, eager, every tensor passed through ``place`` (the
    rules' layout on the mesh, or as it is): the tokens, the first step's
    logits, kernel 1's launches and host ms a decode step."""
    from repro_torch.models import decode_step, init_cache, prefill

    b, s = len(prompts), max(len(p) for p in prompts)
    inputs = torch.zeros((b, s), dtype=torch.int32)
    for i, p in enumerate(prompts):
        inputs[i, :len(p)] = torch.as_tensor(p)
    plens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    cache = place(init_cache(cfg, b, MESH_SHAPE["max_seq_len"], device="cuda"), "cache")
    batch = place({"inputs": inputs.cuda(), "lengths": plens.cuda()}, "batch")
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    with torch.no_grad():
        logits, cache, lengths = prefill(params, cfg, batch["inputs"], cache,
                                         prompt_lengths=batch["lengths"])
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        tokens, first = [full(token).cpu()], None
        torch.cuda.synchronize()
        kernel = kmod.decode_attention
        n0, ms = kernel.launches, []
        for _ in range(MESH_SHAPE["new"]):
            t0 = time.perf_counter()
            logits, cache, lengths = decode_step(params, cfg, token, cache, lengths)
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if first is None:
                first = full(logits).float()
            tokens.append(full(token).cpu())
    return {"tokens": torch.stack(tokens, dim=1), "logits": first,
            "launches": kernel.launches - n0, "ms": ms}


def mesh_phase(torch, kmod, records, pod) -> None:
    """[mesh]: the multi-device layer on the card. A one-rank NCCL group on
    the H100 and its (1, 1) ``make_host_mesh()``; ``compressed_psum`` over
    it equals int8 quantise-then-dequantise; full-width gemma-2b in bf16
    (phase 4's B 8, max_seq_len 1024, prompts and 32 new tokens) with
    params, cache and inputs laid out by the rules (kernel 1 launched inside
    ``local_map``) against the same steps on plain tensors: greedy tokens
    equal, the first step's logits within LOGIT_ATOL_BF16 (expected equal:
    the same kernels in the same order), 18 kernel-1 launches a step, host
    ms a step printed; then the pod dry run's cells (``pod``)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as S
    from repro_torch.models import init_params
    from repro_torch.training import make_prompts
    from repro_torch.training.compression import (
        compressed_psum,
        dequantize_int8,
        quantize_int8,
    )

    t_phase = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = M.make_host_mesh()
        if dist.get_backend() != "nccl" or mesh.device_type != "cuda" or tuple(
                mesh.shape) != (1, 1):
            raise SystemExit(f"[mesh] expected a (1, 1) NCCL mesh on the card, got "
                             f"{dist.get_backend()} {mesh}")
        print(f"[mesh] {mesh}, backend {dist.get_backend()}")
        g = torch.Generator(device="cuda").manual_seed(11)
        x = torch.randn(1 << 20, generator=g, device="cuda") * 3.0
        got = compressed_psum(x, dist.group.WORLD)
        want = dequantize_int8(*quantize_int8(x))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit("[mesh] compressed_psum over one rank != quantise-then-dequantise: "
                             f"max |d| {(got - want).abs().max().item():.3e}")
        print("[mesh] compressed_psum over the one-rank group == int8 quantise-then-dequantise "
              f"(1M fp32 values, absmax {x.abs().max().item():.3f}): equal")

        cfg = get_config(MESH_ARCH)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        prompts = make_prompts(cfg, MESH_SHAPE["batch"], 64, 512, seed=0)
        fsdp = S.needs_fsdp(cfg, mesh)
        layout = {"cache": lambda t: S.cache_shardings(t, mesh),
                  "batch": lambda t: S.batch_shardings(t, mesh)}
        on_mesh = lambda t, kind: S.distribute(t, layout[kind](t), mesh)
        dparams = S.distribute(params, S.param_shardings(params, mesh, fsdp=fsdp), mesh)
        _greedy(torch, kmod, cfg, params, prompts[:1], lambda t, kind: t)   # warm-up
        plain = _greedy(torch, kmod, cfg, params, prompts, lambda t, kind: t)
        from repro_torch import dtensor as dtm

        dtm.SITES.clear()
        sharded = _greedy(torch, kmod, cfg, dparams, prompts, on_mesh)
        steps = MESH_SHAPE["new"]
        per_step = sharded["launches"] / steps
        records["decode_attention"]["launches"] += sharded["launches"]
        d = (sharded["logits"] - plain["logits"]).abs().max().item()
        same = bool(torch.equal(sharded["tokens"], plain["tokens"]))
        pm = sorted(plain["ms"][1:])
        dm = sorted(sharded["ms"][1:])
        print(f"[mesh] {MESH_ARCH} bf16 B {MESH_SHAPE['batch']} max_seq_len "
              f"{MESH_SHAPE['max_seq_len']}, {steps} greedy steps: tokens equal {same}; first "
              f"step's logits max |d| {d:.4e} (tol {LOGIT_ATOL_BF16[MESH_ARCH]}); kernel-1 "
              f"launches a step: DTensor {per_step:g}, plain {plain['launches'] / steps:g}; "
              f"local_map sites {sorted(dtm.SITES)}; host ms a step (median of steps 2-"
              f"{steps}, eager): DTensor {dm[len(dm) // 2]:.3f}, plain {pm[len(pm) // 2]:.3f}")
        if not same or d > LOGIT_ATOL_BF16[MESH_ARCH] or per_step != _n_layers(cfg, "decode"):
            raise SystemExit("[mesh] the (1, 1)-mesh step parts from the plain step")
        del dparams, params
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    pod.finish()
    print(f"[mesh] {time.perf_counter() - t_phase:.1f} s")


def check_launches(arch, what, paged, cfg, stats, info) -> None:
    """Each counted kernel launched ``expected_launches`` times in the run,
    counting eager launches plus graph replays x captured launches."""
    want = expected_launches(arch, paged, cfg, stats)
    if info["launches"] != want:
        raise SystemExit(f"{arch} {what}: launches {info['launches']} != {want} "
                         f"({_n_layers(cfg, "decode")} attention / "
                         f"{_n_layers(cfg, "scan")} recurrent layers x "
                         f"{info['decode_steps']} decode steps, "
                         f"x {info['prefill_calls']} prefill calls; counted {info['counted']}, "
                         f"{info['graph_replays']} replays x {info['captured_launches']})")


def side_by_side(side) -> dict:
    """The bf16 graph and eager runs of one model and layout, figure by
    figure: [graph, eager]."""
    g, e = side["graph"][0], side["eager"][0]
    pick = lambda run, *keys: functools.reduce(lambda d, k: (d or {}).get(k), keys, run)
    out = {}
    for label, keys in (("step_ms_batch8", ("decode_step_ms_batch8_mean",)),
                        ("decode_tok_s_batch8", ("decode_tok_s_batch8",)),
                        ("decode_tok_s_run", ("decode_tok_s",)),
                        ("profiled_device_ms", ("profile", "device_busy_ms_per_step")),
                        ("profiled_idle_share", ("profile", "device_idle_share")),
                        ("profiled_union_busy_ms", ("profile", "union_busy_ms_per_step")),
                        ("profiled_gaps_inside_ms", ("profile", "gaps_inside_ms_per_step")),
                        ("profiled_gaps_between_ms", ("profile", "gaps_between_ms_per_step")),
                        ("kernels_per_step", ("profile", "kernels_per_step"))):
        out[label] = [pick(g, *keys), pick(e, *keys)]
    # the profiler stretches a graph step (see PERF.md): the share of the
    # unprofiled host-clock step in which no profiled kernel runs
    out["idle_share_of_step"] = [1.0 - pick(r, "profile", "union_busy_ms_per_step")
                                 / r["decode_step_ms_batch8_mean"] for r in (g, e)]
    out["replay_device_ms_events"] = pick(g, "replays_timed", "replay_device_ms")
    out["replay_idle_share_events"] = pick(g, "replays_timed", "device_idle_share")
    out["capture_ms"] = g["capture_ms"]
    out["graph_replays"] = g["graph_replays"]
    out["captured_launches"] = g["captured_launches"]
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


if __name__ == "__main__":
    sys.exit(main())
