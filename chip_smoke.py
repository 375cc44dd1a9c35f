#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (awq_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N]

Phases (each failure ends the run with a non-zero exit):

1. Print the card's name and power limit; build the CUDA kernels from
   ``awq_tpu_torch/csrc`` with nvcc (one process per unit, in parallel).
2. Hold every kernel against its plain PyTorch version on the card, at the
   shapes the Llama-3-8B main path gives it, with the tolerance stated;
   time the kernel, the plain version and one PyTorch library call (for
   the megakernels, which no single PyTorch call computes: the stacked
   per-kernel path's device time for the same step), beside the least
   time the card could take (``bound_ms``).
   That covers K1-K5 at batch 1, K1's GEMM at 16, 64, 200 and 1000 rows
   (each line with the plan's orientation and split count), K1 at 8 and
   32 rows and K2 at 8 rows of
   ragged lengths as the batched stacked path calls them, the batched
   megakernel K6 at 8 and 32 rows (its in-place cache write included) and
   the standalone KV append K7 (since the append rides K2, K8 and K9 on the
   path, it is their card-side reference); then the paged KV path: K8 (paged flash decode) on
   K2's 8 rows over a permuted pool of 256-position pages (yardsticks: K2
   on the contiguous cache, SDPA on the gathered view), K6's paged mode at
   8 and 32 rows (yardstick: the contiguous K6 on the same rows; the pool
   outside the rows' write positions must stay bit-equal to the plain
   version's) and K7's paged mode (exact). Then the int8 KV cache: K4's
   int8 mode (token entry at 32 layers with the head, and the layer entry;
   yardstick the bf16 K4), K6's int8 slot mode at 8 and 32 rows (yardstick
   the bf16 K6), K9 (int8 flash decode) at batch 1 and on K2's 8 ragged
   rows (yardsticks K2 on the dequantized bf16 cache and SDPA on it) and
   K7's int8 mode (exact). An int8 megakernel's in-place write must hold,
   at each row's position, ``quantize_kv`` of the k/v it returned, bit for
   bit, and leave the rest of the cache bit-equal to the plain version's.
   Then W3 (pack_int3 codes): K1's W3 mode (GEMV at 1 and 8 rows, GEMM at
   32, 200 and 1000, every projection and the head; yardstick
   ``torch.matmul`` on the dequantized weight) and the W3 modes of K4
   (layer and token entries, a W3 head), K5 and K6 (slot, int8 and paged,
   their in-place writes held as above) over a 32-layer W3 model. Then an
   f16 model's kernels: K1 (GEMV and GEMM), K2, K8, K3 and K9 over f16.
   Then the append fused into K2, K8 and K9 on the 8 rows with a row at
   T - 1 and one past T, at Llama-3-8B's, Falcon-7B's and MPT-7B's heads
   (K9 also in the quantize-first order), and the device-length K2 and K9:
   each append bit-equal to the standalone K7's and the plain append's, each
   output bit-equal to a launch that appended elsewhere (``append_to``).
   Last, the int8-activation prefill at the four projections: the
   per-token quantization kernel (at 32, 40, 200, 512 and 1000 rows of
   both input widths, in K11's channel order and K10's; its plain version
   timed at 1000; and at 40 rows of 36864 and 57344 channels, past the
   kernel's one pass), K11 (over one layer's int8 weight cache, built on
   the card) at 32, 40, 200 and 1000 rows and K10 (the W4 codes
   requantized in the kernel) at 40, 512 and 1000, each bit-equal to its
   plain version, K11 to K10, and the card's cache to the CPU's build;
   yardsticks ``torch._int_mm`` with the same epilogue and K1's GEMM, and
   for K10 the two-launch composition it fuses (``requant_w8`` on the
   card, then K11), bit-equal to it.
   Then the tensor-parallel halves K12 (attention half) and K13 (MLP half)
   on one rank's shards of Llama-3-8B at tp = 1, 2 and 4 (q/kv heads and
   intermediate 32/8/14336, 16/4/7168, 8/2/3584), layer 5: K12 at lengths
   0, 1000 and 4000 over a bf16 cache and 1000 over an int8 one (its
   in-place write held as above), K13, and both in W3 at tp = 2; the
   yardstick is the stacked per-rank path's device time for the same half.
   Last, the falcon path's attention: K14 (single-layer flash decode) at
   Falcon-7B's shape (B 1, one kv head, 71 q heads, head_dim 64; lengths 1,
   1000, 2047) and Llama-3-8B's (B 1 and 8, 8 kv heads of 4; lengths 1000
   and 4000), and K3's head_dim-64 mode at Falcon-7B's shape (S 512 from
   0 and from 700, S 1000 from 0: the 1000-token prompt); yardstick SDPA.
   Then the ALiBi modes (MPT, BLOOM), yardstick SDPA with the same bias as
   an additive mask: K2 with slopes at MPT-7B's heads (32 q over 32 kv
   heads, head_dim 128; B 1 at lengths 1000 and 4000, and the 8 ragged rows),
   K3 with slopes (S 512 from 0 and from 700, bf16 and f32 caches) and K14
   with slopes at BLOOM-560m's 16 heads of 64 (lengths 1, 1000, 2047 read in
   device memory) and at 12 heads (the closest-power-of-two slopes); zero
   slopes give each kernel's bits without slopes. Last, K4's MPT shape
   (units ``megakernel_mpt``, ``megakernel_mpt_w3``) over a 32-layer MPT-7B
   in W4 and in W3: the layer entry at layer 5 over lengths 0, 1000 and
   4000, the token entry with the quantized tied head at length 1000 (its
   position in device memory, bit-equal to the host-length launch);
   yardstick the stacked path's device time. Then the per-row steps of the
   other families: K2, K8 and K9 at Falcon-7B's heads (71 q heads over one
   kv head, head_dim 64: the unit ``decode_attn_wide``) on K2's 8 ragged
   rows, K8 and K9 with ALiBi slopes at MPT-7B's and BLOOM-560m's heads and
   K2 with slopes at BLOOM-560m's, on the same rows (K8 over pages of 256
   equal to K2 bit for bit; K9 beside K2 on the dequantized cache), and
   K7's int8 mode at head_dim 64 (exact); yardstick SDPA. Last, phase
   3l's attention: at StarCoder's heads (48 q heads over ONE kv head at
   head_dim 128) K14 at B 1 (lengths 1, 1000, 2047 in device memory, the
   grid planned for the bucket), K2, K8 and K9 of the wide unit on the 8
   ragged rows (K8 over pages of 256 equal to K2) and K3 (S 512 from 0 and
   700); K2 at OPT-6.7B's heads (32 over 32 of 128) at length 1000 in device
   memory; and the repair of the served step: K2 and K9 at Llama-3-8B's and
   OPT-6.7B's heads and K14 at Falcon-7B's and StarCoder's with their
   lengths in device memory and grids planned for the bucket, each
   bit-equal to the host launch planned for its length at 1, 255, 1000 and
   2047, both timed. Last, the window mode of K2 and K9 (``flash_verify``,
   ``flash_verify_int8``: the attention of ``verify_step_batched``, XLA in the
   JAX package, so no TPU kernel): 8 queries a row over the row's prefix and
   its causal window, at Llama-3-8B's heads at B 1 (lengths 1000 and 4000)
   and on K2's 8 ragged rows, and at Falcon-7B's (71 q heads over one kv
   head, head_dim 64) on the 8 rows; bf16, f16 and int8 caches; each row's
   output within 2^-6 of that row's largest value, the window the launch
   wrote bit-equal to the plain append's
   (codes and scales); yardsticks SDPA with the prefix-and-causal mask on
   the (dequantized) cache and K2 (K9) on the same rows with one query.
3. Serve four requests (prompts of 16, 200 and 1000 random ids, 32 greedy
   new tokens each, the second continuing the first's dialogue, then a
   24-token follow-up continuing the third's) through ``InferenceEngine``
   on a random W4A16-g128 model of Llama-3-8B's widths with a W4 head,
   twice: on the megakernels (the default) and with
   ``AWQ_TPU_DISABLE_MEGAKERNEL=1`` (the stacked per-kernel path). The
   greedy decode replays a captured step a token (``DecodeLoop``), which
   calls no kernel wrapper, so each path's main run is profiled: the launch
   counts are set to 0 before it and read after it, and the launches are
   the kernels of each counter's symbol in the device trace. K4 and K5
   must run in the first, K1-K3 in the second, both by the wrappers'
   counts and by the trace's. The requests run again unprofiled (TTFT,
   ms/token) and with the engine's loop taken away (one ``forward`` call a
   token at a host position): its ids must equal the graph's bit for bit
   on both paths (K4 and the stacked attention kernels split by the length
   they read under the graph). Then the host's time
   to queue a replay, a profile of replays (kernels, idle share) and the
   graphs' count, capture time and pool.
3i. Phase 3's model through the port's ``save_checkpoint`` and
   ``load_checkpoint`` (every array equal), served as phase 3 serves it
   (ids equal to phase 3's), a sampled round on the graph and on the
   forward loop from one seed (ids equal), then behind the port's
   ``ModelWorker`` as
   ``input_ids`` over HTTP (ids equal to phase 3's); last, K4 at the served
   lengths with its position in device memory, bit-equal to the launch
   given the length as a host int, timed both ways.
3b. Serve twelve requests (prompts of 16, 24, 200 and 1000 ids in rotation,
   32 greedy new tokens each) through a ``BatchEngine`` of 8 slots over the
   same model, a new request joining every few steps while the others
   decode; again twice: on K6 (the default) and with
   ``AWQ_TPU_DISABLE_MEGAKERNEL=1`` (K1 GEMV at 8 rows, K2 with its fused
   append). K6 must grow in the first, K1, K2 and the appends (counted
   under K7's name) in the second. The copy of a prompt's
   prefix from the staging cache into its slot is timed by prompt length.
3c. Serve phase 3b's twelve requests through an 8-slot ``PagedBatchEngine``
   with pages of 256: with the default pool of 32 pages (greedy ids must
   equal phase 3b's on K6 for all twelve) and with a pool of 12 pages,
   which must preempt at least once while every request completes; each
   on K6's paged mode and with ``AWQ_TPU_DISABLE_MEGAKERNEL=1`` (K1, K8 and
   its paged append). Prints ms/step, tokens/s, the pool's bytes and the peak
   device memory, and profiles eight steps of eight live requests.
3d. The int8 KV cache: phase 3's four requests through
   ``InferenceEngine(cache_dtype="int8")`` and phase 3b's twelve through an
   8-slot ``BatchEngine(cache_dtype="int8")``, each on the megakernels (K4's
   and K6's int8 modes must grow) and with ``AWQ_TPU_DISABLE_MEGAKERNEL=1``
   (K9 and its int8 appends must grow); every prompt takes the stacked
   prefill, as K5 takes no int8 cache. Prints the caches' bytes, the peak
   device memory against phase 3b's, and how many requests' greedy ids
   equal the bf16 runs' (information: int8 changes the numbers).
3m. Speculative decoding over phase 3's model (run after 3d): (a) four
   requests whose prompts repeat a random 16-gram (3, 4, 8, 16 times), each
   a fresh dialogue, through ``InferenceEngine.generate_speculative(k=7)``
   (greedy, the host loop: a window of 8 a step through ``forward``, one K5
   launch; then with ``device_loop=True``: a fixed window of 8 a step, K5
   too) and through the same engine's ``generate`` (K4 on the graph): ids
   equal, or parting only where the reference's top-two logit gap is at
   most 1e-2 of its largest logit (the near-tie rule); ms per verify step
   against ms per decode step, tokens/s, drafted and accepted; the host
   loop's verify step in parts (the drafter, K5 and the head with the read)
   and profiled;
   (b) phase 3b's twelve requests through an 8-slot ``BatchEngine(spec_k=7)``
   over a bf16 and an int8 cache (every step ``verify_step_batched``: K1's
   GEMM over 64 rows and the window mode of K2 or K9 once a layer, which
   appends the windows: no K7 and no fused append, no K6; by the counters),
   ids against phases 3b's and 3d's K6 ids under the same rule, and a
   sampled run over bf16; a verify step's and a K6 decode step's host-clock
   time at the run's lengths, one verify step's launches, and a profile of
   verify steps (kernels, idle share).
3e. The W3 model (W3-g128 pack_int3 weights and a W3 head from
   ``quantize_head``, at ``--layers`` as phase 3): phase 3's four
   requests through ``InferenceEngine`` and phase 3b's twelve through an
   8-slot ``BatchEngine``, on the megakernels' W3 modes (K4, K5, K6 W3
   counts must grow) and with ``AWQ_TPU_DISABLE_MEGAKERNEL=1`` (K1's W3
   counts must grow); then the twelve through K6's int8 W3 mode and its
   paged W3 mode (ids equal the W3 slot engine's). Prints the weight bytes
   and peak memory against the W4 model's and how many requests' greedy ids
   equal the W4 runs' (information).
3f. The int8-activation prefill over phase 3's model (run after 3d):
   phase 3's four requests through ``InferenceEngine`` with
   ``RuntimeConfig(prefill_w8=True)`` (the int8 weight cache, K11 for the
   200- and 1000-token prompts) and with ``cfg.prefill_a8`` alone (K10 for
   the 1000-token prompt, K1 for the 200), then phase 3b's twelve through an
   8-slot ``BatchEngine`` each way and through a ``PagedBatchEngine`` of 32
   pages with the cache. Prints the cache's build seconds and GiB, TTFT
   beside phase 3's, peak memory and the kernels of a 1000-token prefill;
   the two configurations' greedy ids must be equal where both prefill in
   int8 (or on K5) over the same history, and the paged engine's equal the
   slot engine's.
3g. Tensor-parallel serving over phase 3's model (seed 0): (a) at tp = 1
   over NCCL in this process, phase 3's four requests through
   ``InferenceEngine(RuntimeConfig(mesh=...))``, once over a bf16 and once
   over an int8 cache: every prompt on the stacked path, every decode step
   on K12 and K13 with an all-reduce after each (K4 and K5 must not run);
   (b) at tp = 2 over gloo, two spawned processes sharing the card (they
   meet through a FileStore under ``build/``, with a timeout), each
   building 8 of the model's layers (``TP2_LAYERS``) from the seed and
   serving the same requests. Prints
   TTFT, ms/token (in (b) two ranks time-sliced on one card, no TP
   speed-up), kernels per decode step and idle share (a), each rank's
   peak memory (b), and how many requests' greedy ids equal phase 3's on
   K4 (information; both ranks of (b) must agree).
3h. Falcon-7B at full width and depth (32 layers), random
   W4-g64 weights and head from seed 0 (``init_qparams``, ``quantize_head``),
   a bf16 cache of 2048 positions: phase 3's four requests through
   ``InferenceEngine`` on the stacked path, decode through K14 per layer
   (K2 cannot take 71 q heads per kv head at head_dim 64), prefill on K1's
   GEMM and K3's head_dim-64 mode; no megakernel, and K14 runs in no other
   phase. Driven as phase 3 drives its paths. Prints TTFT, ms/token,
   GB/token, kernels per decode step, idle share, peak memory and the ids.
3j. MPT-7B at full width and depth (``awq_tpu/benchmark.py:60-65``'s
   widths: 32 heads of 128 over 32 kv heads, I 16384, vocab 50432), random
   W4-g128 weights from seed 0, the tied embedding quantized as the head,
   a bf16 cache of 2048 positions: phase 3's four requests through
   ``InferenceEngine`` under the graph, on K4's MPT shape (one launch a
   token by the device trace; the forward loop's ids equal the graph's) and
   on the stacked path (K1, K2 with slopes); every prompt on K1's GEMM and K3
   with slopes. Then the four requests through ``ModelWorker`` over HTTP,
   the ids equal to the K4 run's. Prints what phase 3 prints.
3k. Falcon-7B (W4-g64) and MPT-7B (W4-g128, ``zero_mean``, the tied head
   quantized) at 32 layers and full width: phase 3b's twelve requests
   through an 8-slot ``BatchEngine`` over a bf16 and over an int8 cache,
   then through an 8-slot ``PagedBatchEngine`` with pages of 256 (greedy ids
   equal to the bf16 slot engine's, bit for bit). Every step is the stacked
   path: K1's GEMV at 8 rows, K2, K9 or K8 at head_dim 64 and 71 q heads a
   kv head (falcon) or with ALiBi slopes (MPT), each appending; no K14, K6
   or K4 (by the counters and the device trace). Prints what phase 3b
   prints, peak memory and the split decode's instances a step.
3l. OPT-6.7B, StarCoder and Pythia-6.9B at their published widths and
   depths (32, 40 and 32 layers; facebook/opt-6.7b, bigcode/starcoder,
   EleutherAI/pythia-6.9b), random W4-g128 zero-mean weights from seed 0,
   the head quantized: phase 3's four requests through ``InferenceEngine``
   under the graph (K2, or K14 at StarCoder's 48-over-1 group, split by
   the length read; the forward loop's ids equal the graph's), then phase
   3b's twelve through an 8-slot ``BatchEngine`` over a bf16 cache at the
   models' first 8 layers (StarCoder also over an int8 cache and through a
   ``PagedBatchEngine``, ids equal to the slot engine's). No K4, K5 or K6.
   Prints what phases 3 and 3b print.
4. At the same widths and 2 layers, feed the same tokens through
   ``forward`` on the kernel path and on the plain path and compare
   logits: a 100-token prefill and 8 decodes on the stacked path, a
   20-token chunk prefill and 8 decodes on the megakernels, and both again
   over an int8 cache; then one ``decode_step_batched`` of 8 rows at ragged
   lengths on both paths, over a bf16 and over an int8 cache, and one
   ``decode_step_paged`` of the same rows over a permuted pool; at the end,
   ``tp_forward`` at tp = 1 (phase 3g's NCCL group): a 100-token prefill
   and 8 decodes on K12/K13, over a bf16 and an int8 cache. Then a W3
   model on the stacked path and on the megakernels, one batched and one
   paged W3 step on K6, and an f16 model with an f16 cache on the stacked
   path; then a 100-token prefill with the int8 weight cache (K11) and a
   600-token one with ``prefill_a8`` alone (K10); then a 2-layer Falcon-7B
   model, a 100-token prefill and 16 decodes (K14 once per layer and step),
   both paths also against the same model in f32: the kernel path no
   further from it than 1.25 times the plain path. Then the ALiBi families
   at 2 layers, within 5e-2 of the largest logit: MPT-7B's widths on K4's
   MPT shape and on the stacked path, BLOOM-560m's (random biases) on the
   stacked path, K14 and K3 with slopes once per layer and step. Last,
   the same three families' per-row steps: one ``decode_step_batched`` of
   8 ragged rows over a bf16 and an int8 cache and one ``decode_step_paged``
   over pages of 256, each within 5e-2 of the largest logit, its mode of K2,
   K9 or K8 once a layer, no K14. Then phase 3l's three families at 2
   layers: a 100-token prefill and 8 decodes through ``forward`` and one
   batched step of 8 ragged rows (StarCoder's also over an int8 cache and
   a page pool), within 5e-2 of the largest logit.
5. Print ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

It exits non-zero, printing no result, where CUDA is not available or the
port is not beside it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
INT8_OPS = 1979e12             # H100 SXM dense int8 tensor-core peak
LLAMA3_8B = dict(arch="llama", vocab_size=128256, hidden_size=4096,
                 intermediate_size=14336, num_layers=32, num_heads=32,
                 num_kv_heads=8, head_dim=128, max_position_embeddings=8192,
                 rope_theta=500000.0, dtype="bfloat16")
G = 128
# Falcon-7B at the published widths of tiiuae/falcon-7b's config.json
# (awq_tpu/benchmark.py:54-59): 71 query heads over ONE kv head at head_dim
# 64, hidden 4544 (no multiple of 128: W4 at group 64, benchmark.py:112),
# one LayerNorm with bias feeding both branches of a parallel block, an
# exact-GELU MLP
FALCON_7B = dict(arch="falcon", vocab_size=65024, hidden_size=4544,
                 intermediate_size=18176, num_layers=32, num_heads=71, num_kv_heads=1,
                 head_dim=64, max_position_embeddings=2048, norm="layernorm", act="gelu",
                 parallel_block=True, single_ln=True, dtype="bfloat16")
FALCON_G = 64
# MPT-7B at the widths of awq_tpu/benchmark.py:60-65 (mosaicml/mpt-7b's
# config.json: d_model 4096, 32 heads of 128 over 32 kv heads, expansion 4,
# vocab 50432): bias-free LayerNorm, ALiBi, the erf-GELU MLP; its head is the
# tied embedding
MPT_7B = dict(arch="mpt", vocab_size=50432, hidden_size=4096, intermediate_size=16384,
              num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
              max_position_embeddings=2048, norm="layernorm", norm_bias=False, act="gelu",
              pos_embed="alibi", tie_word_embeddings=True, dtype="bfloat16")
# BLOOM-560m (bigscience/bloom-560m's config.json: hidden 1024, 16 heads of 64,
# 24 layers, vocab 250880): the embedding LayerNorm, LayerNorms and linears
# with bias, the tanh GELU, ALiBi
BLOOM_560M = dict(arch="bloom", vocab_size=250880, hidden_size=1024, intermediate_size=4096,
                  num_layers=24, num_heads=16, num_kv_heads=16, head_dim=64,
                  max_position_embeddings=2048, norm="layernorm", act="gelu_tanh",
                  pos_embed="alibi", attn_bias=True, mlp_bias=True, embed_ln=True,
                  tie_word_embeddings=True, dtype="bfloat16")
# The families of phase 3l at their published widths (their config.json),
# served on the stacked path: OPT-6.7B (facebook/opt-6.7b: hidden 4096,
# ffn 16384, 32 layers of 32 heads of 128, vocab 50272, 2048 positions from
# row 2, ReLU, LayerNorms and linears with bias, the tied head); StarCoder
# (bigcode/starcoder: n_embd 6144, n_inner 24576, 40 layers, 48 heads over
# ONE kv head (multi_query), vocab 49152, 8192 positions, the tanh GELU, the
# tied head); Pythia-6.9B (EleutherAI/pythia-6.9b: hidden 4096, 16384, 32
# layers of 32 heads of 128, vocab 50432, rope over a quarter of the head
# (rotary_pct 0.25), the parallel block with two norms, the untied head)
_LN_BIASED = dict(norm="layernorm", attn_bias=True, mlp_bias=True, dtype="bfloat16")
OPT_6_7B = dict(arch="opt", vocab_size=50272, hidden_size=4096, intermediate_size=16384,
                num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
                max_position_embeddings=2048, act="relu", pos_embed="learned",
                tie_word_embeddings=True, **_LN_BIASED)
STARCODER = dict(arch="bigcode", vocab_size=49152, hidden_size=6144, intermediate_size=24576,
                 num_layers=40, num_heads=48, num_kv_heads=1, head_dim=128,
                 max_position_embeddings=8192, act="gelu_tanh", pos_embed="learned",
                 tie_word_embeddings=True, **_LN_BIASED)
PYTHIA_6_9B = dict(arch="neox", vocab_size=50432, hidden_size=4096, intermediate_size=16384,
                   num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
                   max_position_embeddings=2048, act="gelu", pos_embed="rope",
                   rotary_pct=0.25, parallel_block=True, **_LN_BIASED)
NEW_FAMILIES = {"opt": OPT_6_7B, "starcoder": STARCODER, "pythia": PYTHIA_6_9B}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def appended(b: int, nkv: int, hd: int, esize: int) -> int:
    """The cache bytes a K2, K8 or K9 launch writes with its append: each
    row's current k and v (int8 codes and an f32 scale each for K9)."""
    return 2 * b * nkv * (hd * esize + (4 if esize == 1 else 0))


class Timer:
    """Median device time of one call: CUDA events around each call, the
    50 MB L2 flushed before it (the main path finds weights and KV cold).

    The device first spins for ~10 ms (``torch.cuda._sleep``) while the host
    enqueues every repeat, so an interval holds the call's kernels only and
    never a wait for the host to launch them."""

    SPIN_CYCLES = 20_000_000

    def __init__(self, torch, reps: int):
        self.torch, self.reps = torch, reps
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps=None) -> float:
        torch = self.torch
        fn()  # warm: first launches load modules
        torch.cuda.synchronize()
        n = reps or self.reps
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        torch.cuda._sleep(self.SPIN_CYCLES)
        for start, end in zip(starts, ends):
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def check(name, got, ref, rel_tol):
    """Max abs / rel error against the plain version; asserts abs <= rel_tol
    * max|ref|."""
    gf, rf = got.float(), ref.float()
    if not bool(gf.isfinite().all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (gf - rf).abs().max().item()
    scale = rf.abs().max().item()
    rel = err / scale if scale else err
    if err > rel_tol * scale:
        raise AssertionError(f"{name}: max_abs_err {err:.3e} > {rel_tol:g} * "
                             f"max|ref| {scale:.3e}")
    return err, rel


def check_rows(name, got, ref, rel_tol):
    """As :func:`check`, each row of dim 0 against its own max|ref|;
    returns the max abs error and the largest row's error over its scale."""
    gf, rf = got.float(), ref.float()
    if not bool(gf.isfinite().all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (gf - rf).abs().flatten(1).amax(1)
    scale = rf.abs().flatten(1).amax(1)
    rel = err / scale.clamp(min=1e-30)
    bad = (err > rel_tol * scale).nonzero().flatten().tolist()
    if bad:
        r = bad[0]
        raise AssertionError(f"{name}: row {r}: max_abs_err {err[r].item():.3e} > {rel_tol:g} "
                             f"* that row's max|ref| {scale[r].item():.3e}")
    return err.max().item(), rel.max().item()


def phase_kernels(torch, timer, cases_out):
    """Phase 2: each kernel against its plain version at main-path shapes."""
    import torch.nn.functional as F

    from awq_tpu_torch.ops import decode_attn as da
    from awq_tpu_torch.ops import w4a16 as w4

    gen = torch.Generator(device="cuda").manual_seed(1234)
    cfg = LLAMA3_8B
    h, inter, nq, nkv, hd = (cfg["hidden_size"], cfg["intermediate_size"],
                             cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"])
    shapes = {"wqkv": (h, (nq + 2 * nkv) * hd), "wo": (nq * hd, h),
              "wgateup": (h, 2 * inter), "down": (inter, h),
              "head": (h, cfg["vocab_size"])}
    # bf16 output: 2^-9 relative rounding; the plain version rounds each
    # dequantized weight to bf16 too and both sum IC products in other
    # orders: 2^-6 of the output's largest magnitude bounds all of it.
    k1_tol = 2.0 ** -6

    def one_launch(entry, fn):
        """K1's GEMV is one launch a call: its counter moves by one, and a
        torch.profiler trace of one call holds one kernel (a trace that
        recorded no device event at all is taken again, up to eight times:
        the tracer now and then returns a trace without device events)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for _ in range(8):
            before = w4.LAUNCHES[entry]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
            if w4.LAUNCHES[entry] != before + 1:
                raise AssertionError(f"{entry}: {w4.LAUNCHES[entry] - before} counted launches "
                                     "in one call, not 1")
            if n:
                break
        if n != 1:
            raise AssertionError(f"{entry}: {n} device kernels in one call, not 1")

    def k1_case(entry, wname, m, dense3=False, dtype=torch.bfloat16, g=G, dims=None):
        # dense3: K1's W3 mode over pack_int3 codes (IC*3/32 word rows)
        ic, oc = dims or shapes[wname]
        rows = ic * 3 // 32 if dense3 else ic // 8
        x = torch.randn((m, ic), generator=gen, device="cuda").to(dtype)
        qw = torch.randint(-(2**31), 2**31 - 1, (rows, oc), generator=gen,
                           dtype=torch.int32, device="cuda")
        s = (torch.rand((ic // g, oc), generator=gen, device="cuda") + 0.5) * 0.005
        sz = s * (4 if dense3 else 8)
        got = w4.w4a16_matmul(x, qw, s, sz, g, dense3=dense3)
        ref = w4.w4a16_matmul_plain(x, qw, s, sz, g, dense3=dense3)
        torch.cuda.synchronize()
        dt = "" if dtype == torch.bfloat16 else f" {str(dtype)[6:]}"
        gemv = m <= w4.GEMV_MAX_M
        # f32 x: the GEMV computes in f32 (1e-5, as the card tests state)
        tol = 1e-5 if (gemv and dtype == torch.float32) else k1_tol
        err, rel = check(f"{entry} {wname} M={m}{dt} g{g}", got, ref, tol)
        if gemv:
            one_launch(entry, lambda: w4.w4a16_matmul(x, qw, s, sz, g, dense3=dense3))
            again = w4.w4a16_matmul(x, qw, s, sz, g, dense3=dense3)
            if not torch.equal(again, got):
                raise AssertionError(f"{entry} {wname} M={m}: two calls differ")
        w = w4.dequantize(qw, s, sz, g, dtype, dense3)
        ms = timer(lambda: w4.w4a16_matmul(x, qw, s, sz, g, dense3=dense3))
        plain_ms = timer(lambda: w4.w4a16_matmul_plain(x, qw, s, sz, g, dense3=dense3),
                         reps=5)
        lib_ms = timer(lambda: torch.matmul(x, w))
        es = x.element_size()
        nbytes = m * ic * es + rows * oc * 4 + 2 * (ic // g) * oc * 4 + m * oc * es
        b_ms, b_by = bound(nbytes, 2.0 * m * ic * oc)
        del w
        gs = "" if g == G else f" g{g}"
        return dict(name=entry, shape=f"{wname} M={m} {ic}->{oc}{dt}{gs}", max_abs_err=err,
                    max_rel_err=rel, tol=f"{tol:g}*max|ref|", ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms,
                    library=f"torch.matmul on the{dt or ' bf16'}-dequantized weight",
                    **plan_of(entry, m, ic, oc, g, dtype))

    for wname in ("wqkv", "wo", "wgateup", "down", "head"):
        cases_out.append(k1_case("w4a16_gemv", wname, 1))
        log_case(cases_out[-1])
    for m in (16, 64, 200, 1000):
        for wname in ("wqkv", "wo", "wgateup", "down"):
            cases_out.append(k1_case("w4a16_gemm", wname, m))
            log_case(cases_out[-1])
    # the batched stacked path: 8 slots are the GEMV entry's most rows
    # (GEMV_MAX_M), 32 rows take the GEMM entry; every projection and the head
    for entry, m in (("w4a16_gemv", w4.GEMV_MAX_M), ("w4a16_gemm", 32)):
        for wname in shapes:
            cases_out.append(k1_case(entry, wname, m))
            log_case(cases_out[-1])
    # K1's W3 mode (pack_int3, the W3 model's every projection and head):
    # the GEMV at 1 and 8 rows, the GEMM at 32, 200 and 1000
    for m in (1, w4.GEMV_MAX_M, 32, 200, 1000):
        for wname in shapes:
            entry = "w3a16_gemv" if m <= w4.GEMV_MAX_M else "w3a16_gemm"
            cases_out.append(k1_case(entry, wname, m, dense3=True))
            log_case(cases_out[-1])
    # the GEMV at 2 and 5 rows, and over f16 and f32 x at 1 and 8 rows
    for dense3, entry in ((False, "w4a16_gemv"), (True, "w3a16_gemv")):
        for m in (2, 5):
            for wname in ("wqkv", "wgateup"):
                cases_out.append(k1_case(entry, wname, m, dense3=dense3))
                log_case(cases_out[-1])
        for dtype in (torch.float16, torch.float32):
            for m in (1, w4.GEMV_MAX_M):
                cases_out.append(k1_case(entry, "wgateup", m, dense3=dense3, dtype=dtype))
                log_case(cases_out[-1])
    # Falcon-7B's decode GEMVs at its published widths, W4 at group 64
    fh, fi, fv = FALCON_7B["hidden_size"], FALCON_7B["intermediate_size"], FALCON_7B["vocab_size"]
    fq = (FALCON_7B["num_heads"] + 2 * FALCON_7B["num_kv_heads"]) * FALCON_7B["head_dim"]
    for fname, dims in (("falcon wqkv", (fh, fq)), ("falcon wo", (fh, fh)),
                        ("falcon up", (fh, fi)), ("falcon down", (fi, fh)),
                        ("falcon head", (fh, fv))):
        cases_out.append(k1_case("w4a16_gemv", fname, 1, g=FALCON_G, dims=dims))
        log_case(cases_out[-1])
    # an f16 model's x (K1 follows x's dtype)
    cases_out.append(k1_case("w4a16_gemm", "wgateup", 200, dtype=torch.float16))
    log_case(cases_out[-1])

    # bf16 output rounding 2^-9; K3 also rounds P to bf16 for P.V.
    attn_tol = 2.0 ** -6
    t_cache = 4096

    def kv_cache():
        return torch.randn((2, 1, nkv, t_cache, hd), generator=gen,
                           device="cuda").to(torch.bfloat16)

    for length in (1, 1000, 4000):
        cache = kv_cache()
        q = torch.randn((1, nq, hd), generator=gen, device="cuda").to(torch.bfloat16)
        kn, vn = (torch.randn((1, nkv, hd), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(2))
        lens = torch.full((1,), length, dtype=torch.int32, device="cuda")
        got = da.flash_decode(q, kn, vn, cache, lens, max_length=length)
        ref = da.flash_decode_plain(q, kn, vn, cache, lens, max_length=length)
        torch.cuda.synchronize()
        err, rel = check(f"flash_decode len={length}", got, ref, attn_tol)
        k_all = torch.cat([cache[0, :, :, :length], kn[:, :, None]], dim=2)
        v_all = torch.cat([cache[1, :, :, :length], vn[:, :, None]], dim=2)
        ms = timer(lambda: da.flash_decode(q, kn, vn, cache, lens, max_length=length))
        plain_ms = timer(lambda: da.flash_decode_append_plain(q, kn, vn, cache, lens,
                                                              max_length=length), reps=5)
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k_all, v_all, enable_gqa=True))
        nbytes = (nq * hd + 2 * nkv * hd + 2 * nkv * length * hd + nq * hd) * 2
        b_ms, b_by = bound(nbytes + appended(1, nkv, hd, 2), 4.0 * nq * (length + 1) * hd)
        cases_out.append(dict(
            name="flash_decode", shape=f"len={length} nq={nq} nkv={nkv} hd={hd}",
            max_abs_err=err, max_rel_err=rel, tol=f"{attn_tol:g}*max|ref|", ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library="F.scaled_dot_product_attention(enable_gqa=True)",
            **decode_plan_of("flash_decode", 1, nq, nkv, hd, length, 2)))
        log_case(cases_out[-1])

    # S=512 from 0 and 700, and the 1000-token prompt's shape
    for s, start in ((512, 0), (512, 700), (1000, 0)):
        cache = kv_cache()
        q = torch.randn((1, s, nq, hd), generator=gen, device="cuda").to(torch.bfloat16)
        got = da.flash_prefill(q, cache, start)
        ref = da.flash_prefill_plain(q, cache, start)
        torch.cuda.synchronize()
        err, rel = check(f"flash_prefill S={s} start={start}", got, ref, attn_tol)
        end = start + s
        k_all = cache[0, :, :, :end].contiguous()
        v_all = cache[1, :, :, :end].contiguous()
        qt = q.transpose(1, 2).contiguous()
        mask = (torch.arange(end, device="cuda")[None, :]
                <= (start + torch.arange(s, device="cuda"))[:, None])
        ms = timer(lambda: da.flash_prefill(q, cache, start))
        plain_ms = timer(lambda: da.flash_prefill_plain(q, cache, start), reps=5)
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, k_all, v_all, attn_mask=mask, enable_gqa=True))
        pairs = s * start + s * (s + 1) // 2    # (row, key) pairs attended
        nbytes = (2 * s * nq * hd + 2 * nkv * end * hd) * 2
        b_ms, b_by = bound(nbytes, 4.0 * nq * hd * pairs)
        cases_out.append(dict(
            name="flash_prefill", shape=f"S={s} start={start} nq={nq} nkv={nkv}",
            max_abs_err=err, max_rel_err=rel, tol=f"{attn_tol:g}*max|ref|", ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library="F.scaled_dot_product_attention(attn_mask, enable_gqa=True)"))
        log_case(cases_out[-1])

    # K2 over 8 rows at their own lengths (one of them 0), as the batched
    # stacked path calls it; the grid is sized from the longest row
    b, t_b = 8, 2048
    ragged = [1000, 0, 930, 1100, 1015, 850, 1200, 977]
    mx = max(ragged)
    cache = torch.randn((2, b, nkv, t_b, hd), generator=gen, device="cuda").to(torch.bfloat16)
    q = torch.randn((b, nq, hd), generator=gen, device="cuda").to(torch.bfloat16)
    kn, vn = (torch.randn((b, nkv, hd), generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    lens = torch.tensor(ragged, dtype=torch.int32, device="cuda")
    got = da.flash_decode(q, kn, vn, cache, lens, max_length=mx)
    ref = da.flash_decode_plain(q, kn, vn, cache, lens, max_length=mx)
    torch.cuda.synchronize()
    err, rel = check(f"flash_decode B={b} ragged", got, ref, attn_tol)
    k_all = torch.cat([cache[0, :, :, :mx], kn[:, :, None]], dim=2)
    v_all = torch.cat([cache[1, :, :, :mx], vn[:, :, None]], dim=2)
    mask = torch.arange(mx + 1, device="cuda")[None, :] < lens[:, None]
    mask[:, mx] = True
    ms = timer(lambda: da.flash_decode(q, kn, vn, cache, lens, max_length=mx))
    plain_ms = timer(lambda: da.flash_decode_append_plain(q, kn, vn, cache, lens,
                                                          max_length=mx), reps=5)
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        q[:, :, None], k_all, v_all, attn_mask=mask[:, None, None, :], enable_gqa=True))
    nbytes = ((2 * b * nq * hd + 2 * b * nkv * hd + 2 * nkv * hd * sum(ragged)) * 2
              + appended(b, nkv, hd, 2))
    b_ms, b_by = bound(nbytes, 4.0 * nq * hd * (sum(ragged) + b))
    cases_out.append(dict(
        name="flash_decode", shape=f"B={b} ragged len 0..{mx} nq={nq} nkv={nkv}",
        max_abs_err=err, max_rel_err=rel, tol=f"{attn_tol:g}*max|ref|", ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        library="F.scaled_dot_product_attention(attn_mask, enable_gqa=True)",
        **decode_plan_of("flash_decode", b, nq, nkv, hd, mx, 2)))
    log_case(cases_out[-1])

    # K8: the same rows and data, paged: pages of 256 scattered over a
    # permuted pool; its output must be K2's bit for bit (the same plan, the
    # paged functor changes addresses only); yardsticks K2 on the contiguous
    # cache and SDPA on the gathered view (k_all, v_all)
    page, mp = 256, t_b // 256
    pool, tables = scatter_pages(torch, cache[None], mp, page, gen)
    got = da.flash_decode_paged(q, kn, vn, pool, tables, 0, lens, max_length=mx)
    ref = da.flash_decode_paged_plain(q, kn, vn, pool, tables, 0, lens, max_length=mx)
    flat = da.flash_decode(q, kn, vn, cache, lens, max_length=mx)
    torch.cuda.synchronize()
    err, rel = check(f"flash_decode_paged B={b} ragged", got, ref, attn_tol)
    vs_k2, _ = check("flash_decode_paged against K2", got, flat, attn_tol)
    if not torch.equal(got, flat):
        raise AssertionError(f"flash_decode_paged: output differs from K2's on the same rows "
                             f"(max diff {vs_k2:.3e}); the paged functor may change addresses "
                             "only")
    ms = timer(lambda: da.flash_decode_paged(q, kn, vn, pool, tables, 0, lens, max_length=mx))
    plain_ms = timer(lambda: da.flash_decode_paged_append_plain(q, kn, vn, pool, tables, 0,
                                                                lens, max_length=mx), reps=5)
    k2_ms = timer(lambda: da.flash_decode(q, kn, vn, cache, lens, max_length=mx))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        q[:, :, None], k_all, v_all, attn_mask=mask[:, None, None, :], enable_gqa=True))
    pages_read = sum(-(-n // page) for n in ragged)
    b_ms, b_by = bound(nbytes + pages_read * 4, 4.0 * nq * hd * (sum(ragged) + b))
    cases_out.append(dict(
        name="flash_decode_paged",
        shape=f"B={b} ragged len 0..{mx} page {page} nq={nq} nkv={nkv}", max_abs_err=err,
        max_rel_err=rel, tol=f"{attn_tol:g}*max|ref|", ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        library="F.scaled_dot_product_attention on the gathered view",
        yardstick_ms=k2_ms, yardstick="K2 on the contiguous cache (outputs equal)",
        **decode_plan_of("flash_decode_paged", b, nq, nkv, hd, mx, 2, page)))
    log_case(cases_out[-1])
    del cache, k_all, v_all, pool

    # K7: one step's k/v of all 32 layers into an 8-slot cache; exact
    from awq_tpu_torch.ops import cache_append as ca

    n_l = cfg["num_layers"]
    caches = [torch.randn((n_l, 2, b, nkv, t_b, hd), generator=gen,
                          device="cuda").to(torch.bfloat16)]
    caches.append(caches[0].clone())
    kv = torch.randn((n_l, 2, b, nkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    ca.batched_cache_append(caches[0], kv, lens)
    ca.batched_cache_append_plain(caches[1], kv, lens)
    torch.cuda.synchronize()
    err, rel = check("cache_append", caches[0], caches[1], 0.0)
    if not torch.equal(caches[0], caches[1]):
        raise AssertionError("cache_append: the kernel's cache differs from the plain one")
    rows, pos = torch.arange(b, device="cuda"), lens.long()
    kvp = kv.permute(2, 0, 1, 3, 4).contiguous()

    def indexed_copy():
        caches[1][:, :, rows, :, pos] = kvp

    ms = timer(lambda: ca.batched_cache_append(caches[0], kv, lens))
    plain_ms = timer(lambda: ca.batched_cache_append_plain(caches[1], kv, lens), reps=5)
    lib_ms = timer(indexed_copy)
    b_ms, b_by = bound(2 * kv.numel() * 2 + b * 4, 0.0)
    cases_out.append(dict(
        name="cache_append", shape=f"L={n_l} B={b} nkv={nkv} hd={hd} T={t_b}",
        max_abs_err=err, max_rel_err=rel, tol="exact", ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        library="one indexed assignment (index_put_) of the permuted k/v"))
    log_case(cases_out[-1])
    # what a launch costs at all: an empty kernel (torch.cuda._sleep(0))
    # timed as K7 is, with CUDA events around it
    empty_ms = timer(lambda: torch.cuda._sleep(0))
    log(f"  cache_append: {ms:.4f} ms against its bound {b_ms:.4f} ms and an empty kernel's "
        f"event-timed launch {empty_ms:.4f} ms")
    del caches

    # K7 paged: the same step's k/v into a pool of 8 pages per row; exact
    pools = [torch.randn((n_l, 2, 1 + b * 8, nkv, 256, hd), generator=gen,
                         device="cuda").to(torch.bfloat16)]
    pools.append(pools[0].clone())
    tables = (torch.randperm(b * 8, generator=gen, device="cuda") + 1).reshape(b, 8
                                                                            ).to(torch.int32)
    ca.batched_cache_append(pools[0], kv, lens, tables)
    ca.batched_cache_append_plain(pools[1], kv, lens, tables)
    torch.cuda.synchronize()
    err, rel = check("cache_append_paged", pools[0], pools[1], 0.0)
    if not torch.equal(pools[0], pools[1]):
        raise AssertionError("cache_append_paged: the kernel's pool differs from the plain one")
    where, off = tables.long()[rows, pos // 256], pos % 256

    def indexed_copy_paged():
        pools[1][:, :, where, :, off] = kvp

    ms = timer(lambda: ca.batched_cache_append(pools[0], kv, lens, tables))
    plain_ms = timer(lambda: ca.batched_cache_append_plain(pools[1], kv, lens, tables), reps=5)
    lib_ms = timer(indexed_copy_paged)
    b_ms, b_by = bound(2 * kv.numel() * 2 + b * 4 + b * 8 * 4, 0.0)
    cases_out.append(dict(
        name="cache_append_paged", shape=f"L={n_l} B={b} nkv={nkv} hd={hd} page 256",
        max_abs_err=err, max_rel_err=rel, tol="exact", ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        library="one indexed assignment (index_put_) at the rows' pages and offsets"))
    log_case(cases_out[-1])
    del pools


RAGGED = [1000, 0, 930, 1100, 1015, 850, 1200, 977]   # K2's and K9's 8 rows


def quantize_cache(torch, cache):
    """``(codes int8, scales f32)`` of a float cache ``[L, ...]``, the int8
    KV cache's ``quantize_kv`` one layer at a time (its f32 temporaries stay
    one layer's size)."""
    from awq_tpu_torch.ops.cache_append import quantize_kv

    codes = torch.empty(cache.shape, dtype=torch.int8, device=cache.device)
    scales = torch.empty(cache.shape[:-1], dtype=torch.float32, device=cache.device)
    for l in range(cache.shape[0]):
        codes[l], scales[l] = quantize_kv(cache[l])
    return codes, scales


def check_int8_write(torch, name, kern, plain, kv_out, rows, at, tol):
    """The in-place write of an int8 megakernel (K4, K6): at each row's
    position the codes and scales are ``quantize_kv`` of the bf16 k/v the
    kernel returned (``kv_out``, each ``[L, B, nkv, hd]``), bit for bit, and
    dequantized within ``tol`` of the plain version's; everywhere else the
    kernel's cache (``kern``, codes and scales) equals the plain version's
    (``plain``) bit for bit."""
    from awq_tpu_torch.ops.cache_append import dequantize_kv, quantize_kv

    (codes, scales), (pcodes, pscales) = kern, plain
    for i in (0, 1):
        q, s = quantize_kv(kv_out[i])
        # the indexed view [:, i, rows, :, at] is [B, L, nkv, ...]
        c, sc = codes[:, i, rows, :, at].transpose(0, 1), scales[:, i, rows, :, at].transpose(0, 1)
        if not (torch.equal(c, q) and torch.equal(sc, s)):
            raise AssertionError(f"{name}: the codes and scales at each row's position are "
                                 "not quantize_kv of the returned k/v")
        check(f"{name} cache written, kv {i}", dequantize_kv(c, sc),
              dequantize_kv(pcodes[:, i, rows, :, at], pscales[:, i, rows, :, at]
                            ).transpose(0, 1), tol)
    keep = pcodes[:, :, rows, :, at], pscales[:, :, rows, :, at]
    pcodes[:, :, rows, :, at] = codes[:, :, rows, :, at]
    pscales[:, :, rows, :, at] = scales[:, :, rows, :, at]
    same = torch.equal(codes, pcodes) and torch.equal(scales, pscales)
    pcodes[:, :, rows, :, at], pscales[:, :, rows, :, at] = keep
    if not same:
        raise AssertionError(f"{name}: the kernel changed the cache outside the rows' "
                             "write positions")


def phase_int8_kernels(torch, timer, cases_out):
    """Phase 2, the int8 KV cache: K9 (int8 flash decode) at batch 1 and on
    K2's 8 ragged rows, against its plain version; its yardsticks are K2 on
    a bf16 cache holding the same dequantized values and SDPA on that view.
    Then K7's int8 mode (exact), with the bf16 K7 on the same rows as its
    yardstick. Bounds count int8 codes plus f32 scales."""
    import torch.nn.functional as F

    from awq_tpu_torch.ops import cache_append as ca
    from awq_tpu_torch.ops import decode_attn as da

    gen = torch.Generator(device="cuda").manual_seed(5678)
    cfg = LLAMA3_8B
    nq, nkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    attn_tol = 2.0 ** -6          # bf16 output rounding, sums in other orders
    for ragged, t in (([1000], 4096), ([4000], 4096), (RAGGED, 2048)):
        b, mx = len(ragged), max(ragged)
        codes, scales = ca.quantize_kv(torch.randn((2, b, nkv, t, hd), generator=gen,
                                                   device="cuda"))
        deq = ca.dequantize_kv(codes, scales, torch.bfloat16)
        q = torch.randn((b, nq, hd), generator=gen, device="cuda").to(torch.bfloat16)
        kn, vn = (torch.randn((b, nkv, hd), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(2))
        lens = torch.tensor(ragged, dtype=torch.int32, device="cuda")
        what = f"len={mx}" if b == 1 else f"B={b} ragged len 0..{mx}"
        got = da.flash_decode_int8(q, kn, vn, codes, scales, lens, max_length=mx)
        ref = da.flash_decode_int8_plain(q, kn, vn, codes, scales, lens, max_length=mx)
        k2 = da.flash_decode(q, kn, vn, deq, lens, max_length=mx)
        torch.cuda.synchronize()
        err, rel = check(f"flash_decode_int8 {what}", got, ref, attn_tol)
        vs_k2, _ = check("flash_decode_int8 against K2 on the dequantized cache", got, k2,
                         attn_tol)
        k_all = torch.cat([deq[0, :, :, :mx], kn[:, :, None]], dim=2)
        v_all = torch.cat([deq[1, :, :, :mx], vn[:, :, None]], dim=2)
        mask = torch.arange(mx + 1, device="cuda")[None, :] < lens[:, None]
        mask[:, mx] = True
        ms = timer(lambda: da.flash_decode_int8(q, kn, vn, codes, scales, lens, max_length=mx))
        plain_ms = timer(lambda: da.flash_decode_int8_append_plain(
            q, kn, vn, codes, scales, lens, max_length=mx), reps=5)
        k2_ms = timer(lambda: da.flash_decode(q, kn, vn, deq, lens, max_length=mx))
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k_all, v_all, attn_mask=mask[:, None, None, :], enable_gqa=True))
        nbytes = ((2 * b * nq * hd + 2 * b * nkv * hd) * 2 + 2 * nkv * sum(ragged) * (hd + 4)
                  + appended(b, nkv, hd, 1))
        b_ms, b_by = bound(nbytes, 4.0 * nq * hd * (sum(ragged) + b))
        cases_out.append(dict(
            name="flash_decode_int8", shape=f"{what} nq={nq} nkv={nkv}", max_abs_err=err,
            max_rel_err=rel, tol=f"{attn_tol:g}*max|ref|", ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library="F.scaled_dot_product_attention on the dequantized bf16 view",
            yardstick_ms=k2_ms,
            yardstick=f"K2 on the dequantized bf16 cache (max diff {vs_k2:.2e})",
            **decode_plan_of("flash_decode_int8", b, nq, nkv, hd, mx, 1)))
        log_case(cases_out[-1])
        del codes, scales, deq, k_all, v_all

    # K7's int8 mode: one step's k/v of all 32 layers quantized into an
    # 8-slot int8 cache at the ragged rows' lengths; exact
    n_l, b, t_b = cfg["num_layers"], len(RAGGED), 2048
    lens = torch.tensor(RAGGED, dtype=torch.int32, device="cuda")
    codes = torch.randint(-127, 128, (n_l, 2, b, nkv, t_b, hd), generator=gen,
                          dtype=torch.int8, device="cuda")
    scales = torch.rand((n_l, 2, b, nkv, t_b), generator=gen, device="cuda") * 0.03
    c8 = [(codes, scales), (codes.clone(), scales.clone())]
    kv = torch.randn((n_l, 2, b, nkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    kv[0, 1, 2, 3] = 0.0                                  # a zero row: the 1e-6 floor
    ca.batched_cache_append_int8(*c8[0], kv, lens)
    ca.batched_cache_append_int8_plain(*c8[1], kv, lens)
    torch.cuda.synchronize()
    if not (torch.equal(c8[0][0], c8[1][0]) and torch.equal(c8[0][1], c8[1][1])):
        raise AssertionError("cache_append_int8: the kernel's codes or scales differ from "
                             "the plain version's")
    err = rel = 0.0
    cache16 = torch.zeros((n_l, 2, b, nkv, t_b, hd), dtype=torch.bfloat16, device="cuda")
    ms = timer(lambda: ca.batched_cache_append_int8(*c8[0], kv, lens))
    plain_ms = timer(lambda: ca.batched_cache_append_int8_plain(*c8[1], kv, lens), reps=5)
    k7_ms = timer(lambda: ca.batched_cache_append(cache16, kv, lens))
    rows_kv = kv.numel() // hd
    b_ms, b_by = bound(kv.numel() * 2 + kv.numel() + rows_kv * 4 + b * 4, 0.0)
    cases_out.append(dict(
        name="cache_append_int8", shape=f"L={n_l} B={b} nkv={nkv} hd={hd} T={t_b}",
        max_abs_err=err, max_rel_err=rel, tol="exact", ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, library="none",
        yardstick_ms=k7_ms, yardstick="K7 on a bf16 cache, same rows"))
    log_case(cases_out[-1])
    del codes, scales, c8, cache16


def phase_fused_append(torch, cases_out):
    """Phase 2, continued: the append fused into K2, K8 and K9 (each launch
    writes its rows' current token into the layer's cache after its
    attention). On the batched step's 8 rows with the edges (a row of length
    0, one at T - 1 and one past T, whose write is clamped to T - 1, a
    position its attention reads): Llama-3-8B's heads, Falcon-7B's 71 q heads
    over one kv head at head_dim 64 (the wide unit) and MPT-7B's with ALiBi
    slopes, over a bf16 slot cache (K2), a permuted pool of pages of 256 (K8)
    and an int8 cache (K9, also in the int8 ALiBi step's quantize-first
    order: attending over the dequantized token, appending the full one);
    then the device-length entries of K2 and K9 under a bucket. Every append
    bit-equal to the standalone K7's and to the plain append's, and every
    output bit-equal to that of a launch whose append went to another tensor
    (``append_to``) and which left its cache's bits alone: the attention
    never sees its own write. The fused launches' times are the K2, K8 and K9
    cases' (each launch appends); the kernels line puts them beside K7's."""
    from awq_tpu_torch.models.layers import alibi_slopes
    from awq_tpu_torch.ops import cache_append as ca
    from awq_tpu_torch.ops import decode_attn as da

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(13579)
    t = 2048
    rows = [1000, 0, t - 1, 1100, t + 5, 850, 1200, 977]
    b = len(rows)
    lens = torch.tensor(rows, dtype=torch.int32, device="cuda")

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def same(what, *pairs):
        torch.cuda.synchronize()
        for i, (x, y) in enumerate(pairs):
            if isinstance(x, tuple):
                ok = all(torch.equal(u, v) for u, v in zip(x, y))
            else:
                ok = torch.equal(x, y)
            if not ok:
                raise AssertionError(f"fused append, {what}: check {i} (the read cache kept, "
                                     "the outputs equal, the append = K7's, = elsewhere's, "
                                     "= plain's) failed")

    checked = []
    for fam, nq, nkv, hd, alibi in (("Llama-3-8B", 32, 8, 128, False),
                                    ("Falcon-7B", FALCON_7B["num_heads"], 1, 64, False),
                                    ("MPT-7B", 32, 32, 128, True)):
        sl = alibi_slopes(nq, device="cuda") if alibi else None
        cache, q = rnd(2, b, nkv, t, hd), rnd(b, nq, hd)
        kn, vn = rnd(b, nkv, hd), rnd(b, nkv, hd)
        kv = torch.stack([kn, vn])[None].contiguous()
        # K2
        read, away, inplace, plain = (cache.clone() for _ in range(4))
        k7 = cache.clone()[None]
        o_away = da.flash_decode(q, kn, vn, read, lens, max_length=t, slopes=sl, append_to=away)
        o_in = da.flash_decode(q, kn, vn, inplace, lens, max_length=t, slopes=sl)
        ca.batched_cache_append(k7, kv, lens)
        ca.batched_cache_append_plain(plain[None], kv, lens)
        same(f"K2 {fam}", (read, cache), (o_in, o_away), (inplace, k7[0]), (away, k7[0]),
             (inplace, plain))
        # K8 over a permuted pool of pages
        pool, tables = scatter_pages(torch, cache[None], t // PAGE, PAGE, gen)
        read, away, inplace, plain, k7 = (pool.clone() for _ in range(5))
        o_away = da.flash_decode_paged(q, kn, vn, read, tables, 0, lens, max_length=t,
                                       slopes=sl, append_to=away)
        o_in = da.flash_decode_paged(q, kn, vn, inplace, tables, 0, lens, max_length=t,
                                     slopes=sl)
        ca.batched_cache_append(k7, kv, lens, tables)
        ca.batched_cache_append_plain(plain, kv, lens, tables)
        same(f"K8 {fam}", (read, pool), (o_in, o_away), (inplace, k7), (away, k7),
             (inplace, plain))
        del pool, read, away, inplace, plain, k7
        # K9, in the deployed order and the quantize-first one
        codes, scales = ca.quantize_kv(cache.float())
        for order in ("full", "quantize_first"):
            ka, va = kn, vn
            if order == "quantize_first":
                ka, va = (ca.dequantize_kv(*ca.quantize_kv(x), torch.bfloat16) for x in (kn, vn))
            read, away, inplace, plain, k7 = ((codes.clone(), scales.clone()) for _ in range(5))
            o_away = da.flash_decode_int8(q, ka, va, *read, lens, max_length=t, slopes=sl,
                                          k_app=kn, v_app=vn, append_to=away)
            o_in = da.flash_decode_int8(q, ka, va, *inplace, lens, max_length=t, slopes=sl,
                                        k_app=kn, v_app=vn)
            ca.batched_cache_append_int8(k7[0][None], k7[1][None], kv, lens)
            ca.batched_cache_append_int8_plain(plain[0][None], plain[1][None], kv, lens)
            same(f"K9 {fam} {order}", (read, (codes, scales)), (o_in, o_away), (inplace, k7),
                 (away, k7), (inplace, plain))
        checked.append(fam)
        del cache, codes, scales
    # the device-length entries (the captured step's): B 1, a bucket of t - 1
    nq, nkv, hd = LLAMA3_8B["num_heads"], LLAMA3_8B["num_kv_heads"], LLAMA3_8B["head_dim"]
    for length in (1000, t - 1):
        lens1 = torch.tensor([length], dtype=torch.int32, device="cuda")
        cache, q, kn, vn = rnd(2, 1, nkv, t, hd), rnd(1, nq, hd), rnd(1, nkv, hd), rnd(1, nkv, hd)
        kv = torch.stack([kn, vn])[None].contiguous()
        c = [cache.clone() for _ in range(4)]
        host = da.flash_decode(q, kn, vn, c[0], lens1, max_length=length)
        dev = da.flash_decode(q, kn, vn, c[1], lens1, max_length=t - 1, by_length=True)
        ca.batched_cache_append(c[2][None], kv, lens1)
        same(f"K2 device length {length}", (dev, host), (c[1], c[0]), (c[1], c[2]))
        codes, scales = ca.quantize_kv(cache.float())
        c8 = [(codes.clone(), scales.clone()) for _ in range(3)]
        host = da.flash_decode_int8(q, kn, vn, *c8[0], lens1, max_length=length)
        dev = da.flash_decode_int8(q, kn, vn, *c8[1], lens1, max_length=t - 1, by_length=True)
        ca.batched_cache_append_int8(c8[2][0][None], c8[2][1][None], kv, lens1)
        same(f"K9 device length {length}", (dev, host), (c8[1], c8[0]), (c8[1], c8[2]))
        del cache, codes, scales, c, c8
    log(f"  the append fused into K2, K8 and K9 at {', '.join(checked)}'s heads (rows {rows}, "
        f"T {t}; K9 also quantize-first) and the device-length K2 and K9 (lengths 1000, "
        f"{t - 1}): every append bit-equal to K7's and the plain append's, every output "
        "bit-equal to a launch that appended elsewhere, the read cache kept "
        f"({time.perf_counter() - t_phase:.1f} s)")


def phase_int8_prefill_kernels(torch, timer, cases_out):
    """Phase 2, continued: the int8-activation prefill at the four
    Llama-3-8B projections. ``quant_per_token`` (also checked at 36864 and
    57344 channels), K11 (over one layer's int8
    cache, built on the card by ``requant_w8``) at 32, 40, 200 and 1000 rows
    and K10 (the W4 codes requantized in the kernel) at 40, 512 and 1000,
    each bit-equal to its plain version and K11 to K10 where both run; the
    on-card cache of wqkv bit-equal to the CPU's build. Timed against the
    bound (int8 operations at the int8 peak), ``torch._int_mm`` on the same
    int8 operands plus the same epilogue (library) and K1's GEMM on the same
    x (yardstick). The kernel's time holds the quantization's launch."""
    from awq_tpu_torch.ops import w4a16 as w4
    from awq_tpu_torch.ops import w8a8 as q8

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(777)
    cfg = LLAMA3_8B
    h, inter, nq, nkv, hd = (cfg["hidden_size"], cfg["intermediate_size"],
                             cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"])
    shapes = {"wqkv": (h, (nq + 2 * nkv) * hd), "wo": (nq * hd, h),
              "wgateup": (h, 2 * inter), "down": (inter, h)}

    def exact(name, got, ref):
        if not torch.equal(got, ref):
            err = (got.float() - ref.float()).abs().max().item()
            raise AssertionError(f"{name}: not bit-equal (max_abs_err {err:.3e})")

    def int_mm(xq, sx, w8, scol, dtype):
        return ((torch._int_mm(xq, w8.t()).float() * scol) * sx).to(dtype)

    # the quantization at the prefill's rows: K11's natural channel order and
    # K10's (perm), 1000 rows first (the kernels line's shape, the one whose
    # plain version is timed); then, checked only, rows wider than the
    # kernel's one pass (OPT-66B's and BLOOM-176B's down, read in passes)
    for ic in (h, inter):
        for m in (1000, 32, 40, 200, 512):
            x = torch.randn((m, ic), generator=gen, device="cuda").to(torch.bfloat16)
            ref = q8.quant_per_token_plain(x)
            plain_ms = timer(lambda: q8.quant_per_token_plain(x), reps=3) if m == 1000 else None
            for perm in (False, True):
                got = q8.quant_per_token(x, perm=perm)
                torch.cuda.synchronize()
                want = q8.permute64(ref[0]) if perm else ref[0]
                exact(f"quant_per_token M={m} IC={ic}{' perm' if perm else ''}",
                      torch.cat([got[0].float(), got[1]], 1), torch.cat([want.float(), ref[1]], 1))
                b_ms, b_by = bound(m * ic * 3 + m * 4, 0.0)
                cases_out.append(dict(
                    name="quant_per_token", shape=f"M={m} IC={ic}{' perm' if perm else ''}",
                    max_abs_err=0.0, max_rel_err=0.0, tol="0 (bit-equal)",
                    ms=timer(lambda: q8.quant_per_token(x, perm=perm)),
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None))
                log_case(cases_out[-1])
    for ic in (36864, 57344):
        x = torch.randn((40, ic), generator=gen, device="cuda").to(torch.bfloat16)
        ref = q8.quant_per_token_plain(x)
        for perm in (False, True):
            got = q8.quant_per_token(x, perm=perm)
            torch.cuda.synchronize()
            want = q8.permute64(ref[0]) if perm else ref[0]
            exact(f"quant_per_token M=40 IC={ic}{' perm' if perm else ''}",
                  torch.cat([got[0].float(), got[1]], 1), torch.cat([want.float(), ref[1]], 1))
    log("  quant_per_token at IC 36864 and 57344 (passes of 32768 channels), M=40, both "
        "orders: bit-equal to plain")

    for wname, (ic, oc) in shapes.items():
        qw = torch.randint(-(2**31), 2**31 - 1, (ic // 8, oc), generator=gen,
                           dtype=torch.int32, device="cuda")
        s = (torch.rand((ic // G, oc), generator=gen, device="cuda") + 0.5) * 0.005
        sz = s * 8
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w8, scol = w4.requant_w8(qw, s, sz, G)
        torch.cuda.synchronize()
        log(f"  {wname}: one layer's int8 cache built on the card in "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms ({oc * ic / 2**20:.1f} MiB)")
        if wname == "wqkv":
            cw8, cscol = w4.requant_w8(qw.cpu(), s.cpu(), sz.cpu(), G)
            exact("the on-card int8 cache against the CPU build", w8.cpu(), cw8)
            exact("the on-card per-column scales against the CPU build", scol.cpu(), cscol)
        for m in (32, 40, 200, 512, 1000):
            x = torch.randn((m, ic), generator=gen, device="cuda").to(torch.bfloat16)
            xq, sx = q8.quant_per_token(x)
            k1_ms = timer(lambda: w4.w4a16_matmul(x, qw, s, sz, G))
            try:        # the library yardstick only: a refusal leaves it unmeasured
                lib_out = int_mm(xq, sx, w8, scol, x.dtype)
                lib_ms = timer(lambda: int_mm(xq, sx, w8, scol, x.dtype))
            except RuntimeError as e:
                log(f"  torch._int_mm refused {wname} M={m}: {e}")
                lib_out = lib_ms = None
            out = {}
            for name, run, plain, wbytes in (
                    ("w8a8_gemm", lambda: w4.w8a8_matmul(x, w8, scol),
                     lambda: w4.w8a8_matmul_plain(x, w8, scol), oc * ic + oc * 4),
                    ("w4a8_gemm", lambda: w4.w4a8_matmul(x, qw, s, sz, G),
                     lambda: w4.w4a8_matmul_plain(x, qw, s, sz, G),
                     ic // 8 * oc * 4 + 2 * (ic // G) * oc * 4)):
                if m not in {"w8a8_gemm": (32, 40, 200, 1000), "w4a8_gemm": (40, 512, 1000)}[name]:
                    continue
                got, ref = run(), plain()
                torch.cuda.synchronize()
                exact(f"{name} {wname} M={m}", got, ref)
                out[name] = got
                extra = {}
                if name == "w4a8_gemm":
                    # the two-launch composition K10 fuses (a yardstick, not
                    # a path of the program): requant_w8 on the card, then K11
                    def comp():
                        return w4.w8a8_matmul(x, *w4.requant_w8(qw, s, sz, G))
                    exact(f"requant_w8 + K11 against K10, {wname} M={m}", comp(), got)
                    extra = dict(composition_ms=timer(comp),
                                 composition="requant_w8 on the card + K11 on its cache")
                b_ms, b_by = bound(m * ic * 2 + wbytes + m * oc * 2, 2.0 * m * ic * oc, INT8_OPS)
                cases_out.append(dict(
                    name=name, shape=f"{wname} M={m} {ic}->{oc}", max_abs_err=0.0,
                    max_rel_err=0.0, tol="0 (bit-equal)", ms=timer(run),
                    plain_ms=timer(plain, reps=3), bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms, yardstick_ms=k1_ms,
                    library="torch._int_mm on the same int8 operands + the same epilogue",
                    yardstick="K1 GEMM (w4a16_gemm) on the same x", **extra,
                    **plan_of(name, m, ic, oc)))
                log_case(cases_out[-1])
            if lib_out is not None:
                exact(f"{wname} M={m}: torch._int_mm and K10/K11", lib_out,
                      out.get("w8a8_gemm", out.get("w4a8_gemm")))
            if len(out) == 2:
                exact(f"K11 over the cache against K10, {wname} M={m}", out["w8a8_gemm"],
                      out["w4a8_gemm"])
        del qw, s, sz, w8, scol
        torch.cuda.empty_cache()
    log("  K11 over the cache bit-equal to K10 at M=40 and 1000; torch._int_mm's products "
        f"with the same epilogue equal both ({time.perf_counter() - t_phase:.1f} s)")


# tp -> (q heads, kv heads, intermediate size) of one rank of Llama-3-8B
TP_SHAPES = {1: (32, 8, 14336), 2: (16, 4, 7168), 4: (8, 2, 3584)}


def phase_tp_kernels(torch, timer, cases_out):
    """Phase 2, the tensor-parallel halves: K12 (attention half) and K13
    (MLP half) against their plain versions on one rank's shards of
    Llama-3-8B at tp = 1, 2 and 4, layer 5 of 8, K12 at lengths 0, 1000
    and 4000 over a bf16 cache and 1000 over an int8 one, and a W3 case
    at tp = 2. The yardstick is the device time of the stacked per-rank
    path for the same half (K1, rope and K2 or K9, K1; K1, SiLU, K1),
    without the all-reduce."""
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama
    from awq_tpu_torch.models.layers import apply_rope, rms_norm
    from awq_tpu_torch.ops import decode_attn as da
    from awq_tpu_torch.ops import megakernel_tp as mtp
    from awq_tpu_torch.ops.w4a16 import qlinear_apply_stacked

    dev, layer, n_layers, t_cache = "cuda", 5, 8, 4096 + 64
    gen = torch.Generator(device=dev).manual_seed(97)
    tol = 2.0 ** -6      # bf16 outputs, f32 sums in other orders: as K4's layer entry
    for tp, (nq, nkv, inter) in TP_SHAPES.items():
        for w_bit in ((4, 3) if tp == 2 else (4,)):
            sfx = "_w3" if w_bit == 3 else ""
            cfg = ModelConfig(**{**LLAMA3_8B, "num_layers": n_layers, "num_heads": nq,
                                 "num_kv_heads": nkv, "intermediate_size": inter})
            params = llama.init_qparams(cfg, QuantConfig(w_bit=w_bit, group_size=G), gen)
            del params["embed"], params["lm_head"]
            la = llama.fuse_linears(params, cfg)["layers"]
            del params
            H, hd, eps = cfg.hidden_size, cfg.head_dim, cfg.rms_eps
            cos, sin = llama.rope_table(cfg, t_cache, device=dev)
            base = torch.randn((n_layers, 2, 1, nkv, t_cache, hd), generator=gen,
                               device=dev).to(torch.bfloat16)
            attn_bytes = qlinear_bytes(la["wqkv"], 0) + qlinear_bytes(la["wo"], 0) + 2 * H * 2
            attn_flops = 2.0 * (la["wqkv"].in_features * la["wqkv"].out_features
                                + la["wo"].in_features * H)
            runs = [(0, False), (1000, False), (4000, False), (1000, True)] if not sfx else [
                (1000, False)]
            for length, q8 in runs:
                if q8:
                    codes, scales = quantize_cache(torch, base)
                    c = [(codes, scales), (codes.clone(), scales.clone())]
                    kv_pos = 2 * nkv * (hd + 4)
                else:
                    c = [(base.clone(), None), (base.clone(), None)]
                    kv_pos = 2 * nkv * hd * 2
                h = (torch.randn((1, H), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
                step = (h, la["wqkv"], la["wo"], la["ln1"], cos[length], sin[length])
                rest = (layer, length, nq, nkv, eps)
                got = mtp.w4a16_llama_attn_half(*step, c[0][0], *rest, cache_scales=c[0][1])
                ref = mtp.w4a16_llama_attn_half_plain(*step, c[1][0], *rest,
                                                      cache_scales=c[1][1])
                torch.cuda.synchronize()
                name = "megakernel_attn_half" + sfx + ("_int8" if q8 else "")
                pick = torch.arange(n_layers, device=dev) == layer
                one = torch.zeros(1, dtype=torch.long, device=dev)
                at = torch.full((1,), length, dtype=torch.long, device=dev)
                if q8:
                    check_int8_write(torch, name, tuple(x[pick] for x in c[0]),
                                     tuple(x[pick] for x in c[1]),
                                     [x[None, None] for x in got[1:]], one, at, tol)
                else:
                    kv = torch.stack(got[1:])
                    if not torch.equal(c[0][0][layer, :, 0, :, length], kv):
                        raise AssertionError(f"{name}: the cache at {length} is not the k/v")
                    c[1][0][layer, :, 0, :, length] = kv
                    if not torch.equal(c[0][0], c[1][0]):
                        raise AssertionError(f"{name}: the kernel wrote outside its position")
                ms = timer(lambda: mtp.w4a16_llama_attn_half(*step, c[0][0], *rest,
                                                             cache_scales=c[0][1]))
                plain_ms = timer(lambda: mtp.w4a16_llama_attn_half_plain(
                    *step, c[1][0], *rest, cache_scales=c[1][1]), reps=3)

                def stacked_attn():
                    x = rms_norm(h[None], la["ln1"][layer], eps)
                    q, k, v = torch.split(qlinear_apply_stacked(la["wqkv"], layer, x),
                                          [nq * hd, nkv * hd, nkv * hd], dim=-1)
                    q, k = apply_rope(q.reshape(1, 1, nq, hd), k.reshape(1, 1, nkv, hd), cos,
                                      sin, torch.full((1, 1), length, device=dev))
                    lens = torch.full((1,), length, dtype=torch.int32, device=dev)
                    v1 = v.reshape(1, nkv, hd).contiguous()
                    if q8:
                        o = da.flash_decode_int8(q[:, 0].contiguous(), k[:, 0].contiguous(),
                                                 v1, c[1][0][layer], c[1][1][layer], lens,
                                                 max_length=length)
                    else:
                        o = da.flash_decode(q[:, 0].contiguous(), k[:, 0].contiguous(), v1,
                                            c[1][0][layer], lens, max_length=length)
                    return qlinear_apply_stacked(la["wo"], layer,
                                                 o.reshape(1, 1, nq * hd).to(h.dtype))

                yard_ms = device_ms(torch, stacked_attn)
                err = rel = 0.0
                for i, (g_, r_) in enumerate(zip(got, ref)):
                    e, r2 = check(f"{name} tp={tp} len={length} output {i}", g_, r_, tol)
                    err, rel = max(err, e), max(rel, r2)
                b_ms, b_by = bound(attn_bytes + kv_pos * (length + 1),
                                   attn_flops + 4.0 * nq * hd * (length + 1))
                cases_out.append(dict(
                    name=name, shape=f"tp={tp} layer {layer} len={length}", max_abs_err=err,
                    max_rel_err=rel, tol=f"{tol:g}*max|ref|", ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None, library="none",
                    yardstick_ms=yard_ms,
                    yardstick="stacked per-rank path for the half, device time (profiler)"))
                log_case(cases_out[-1])
                del c
            h1 = torch.randn((1, H), generator=gen, device=dev) * 0.5
            got = mtp.w4a16_llama_mlp_half(h1, la["wgateup"], la["down"], la["ln2"], layer, eps)
            ref = mtp.w4a16_llama_mlp_half_plain(h1, la["wgateup"], la["down"], la["ln2"],
                                                 layer, eps)
            torch.cuda.synchronize()
            name = "megakernel_mlp_half" + sfx
            err, rel = check(f"{name} tp={tp}", got, ref, tol)
            ms = timer(lambda: mtp.w4a16_llama_mlp_half(h1, la["wgateup"], la["down"],
                                                        la["ln2"], layer, eps))
            plain_ms = timer(lambda: mtp.w4a16_llama_mlp_half_plain(
                h1, la["wgateup"], la["down"], la["ln2"], layer, eps), reps=3)

            def stacked_mlp():
                xm = rms_norm(h1[None].to(torch.bfloat16), la["ln2"][layer], eps)
                g_, u_ = torch.chunk(qlinear_apply_stacked(la["wgateup"], layer, xm), 2, dim=-1)
                hm = torch.nn.functional.silu(g_.float()).to(torch.bfloat16) * u_
                return qlinear_apply_stacked(la["down"], layer, hm)

            yard_ms = device_ms(torch, stacked_mlp)
            b_ms, b_by = bound(qlinear_bytes(la["wgateup"], 0) + qlinear_bytes(la["down"], 0)
                               + 2 * H * 2, 2.0 * 3 * H * inter)
            cases_out.append(dict(
                name=name, shape=f"tp={tp} layer {layer}", max_abs_err=err, max_rel_err=rel,
                tol=f"{tol:g}*max|ref|", ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, library="none", yardstick_ms=yard_ms,
                yardstick="stacked per-rank path for the half, device time (profiler)"))
            log_case(cases_out[-1])
            del la, base
            torch.cuda.empty_cache()


def phase_f16_attention(torch, timer, cases_out):
    """Phase 2, an f16 model's attention: K2 at len 1000, K8 on K2's 8
    ragged rows over a permuted pool, K3 at S=512 from 700 and K9 at len
    1000 (f16 q over an int8 cache), each against its plain version; the
    library call is SDPA in f16."""
    import torch.nn.functional as F

    from awq_tpu_torch.ops import cache_append as ca
    from awq_tpu_torch.ops import decode_attn as da

    gen = torch.Generator(device="cuda").manual_seed(2468)
    cfg, f16 = LLAMA3_8B, torch.float16
    nq, nkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    tol = 2.0 ** -6               # f16 output rounding, sums in other orders

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(f16)

    def add(name, shape, got, ref, fn, plain, lib, nbytes, flops, library, plan=None):
        torch.cuda.synchronize()
        err, rel = check(f"{name} {shape}", got, ref, tol)
        b_ms, b_by = bound(nbytes, flops)
        cases_out.append(dict(
            name=name, shape=shape, max_abs_err=err, max_rel_err=rel,
            tol=f"{tol:g}*max|ref|", ms=timer(fn), plain_ms=timer(plain, reps=5),
            bound_ms=b_ms, bound_by=b_by, library_ms=timer(lib), library=library,
            **(plan or {})))
        log_case(cases_out[-1])

    for ragged, paged in (([1000], False), (RAGGED, True)):
        b, mx, t = len(ragged), max(ragged), 2048
        cache, q, kn, vn = rnd(2, b, nkv, t, hd), rnd(b, nq, hd), rnd(b, nkv, hd), rnd(b, nkv, hd)
        lens = torch.tensor(ragged, dtype=torch.int32, device="cuda")
        k_all = torch.cat([cache[0, :, :, :mx], kn[:, :, None]], dim=2)
        v_all = torch.cat([cache[1, :, :, :mx], vn[:, :, None]], dim=2)
        mask = torch.arange(mx + 1, device="cuda")[None, :] < lens[:, None]
        mask[:, mx] = True
        nbytes = ((2 * b * nq * hd + 2 * b * nkv * hd + 2 * nkv * hd * sum(ragged)) * 2
                  + appended(b, nkv, hd, 2))
        flops = 4.0 * nq * hd * (sum(ragged) + b)

        def lib():
            return F.scaled_dot_product_attention(
                q[:, :, None], k_all, v_all, attn_mask=mask[:, None, None, :], enable_gqa=True)

        if not paged:
            args = (q, kn, vn, cache, lens)
            add("flash_decode", f"len={mx} nq={nq} nkv={nkv} f16",
                da.flash_decode(*args, max_length=mx), da.flash_decode_plain(*args, max_length=mx),
                lambda: da.flash_decode(*args, max_length=mx),
                lambda: da.flash_decode_plain(*args, max_length=mx), lib, nbytes, flops,
                "F.scaled_dot_product_attention in f16",
                decode_plan_of("flash_decode", b, nq, nkv, hd, mx, 2))
            codes, scales = ca.quantize_kv(cache)
            args8 = (q, kn, vn, codes, scales, lens)
            add("flash_decode_int8", f"len={mx} nq={nq} nkv={nkv} f16 q",
                da.flash_decode_int8(*args8, max_length=mx),
                da.flash_decode_int8_plain(*args8, max_length=mx),
                lambda: da.flash_decode_int8(*args8, max_length=mx),
                lambda: da.flash_decode_int8_plain(*args8, max_length=mx), lib,
                (2 * b * nq * hd + 2 * b * nkv * hd) * 2 + 2 * nkv * mx * (hd + 4)
                + appended(b, nkv, hd, 1), flops,
                "F.scaled_dot_product_attention in f16 on the f16 cache",
                decode_plan_of("flash_decode_int8", b, nq, nkv, hd, mx, 1))
            del codes, scales
        else:
            pool, tables = scatter_pages(torch, cache[None], t // 256, 256, gen)
            argp = (q, kn, vn, pool, tables, 0, lens)
            add("flash_decode_paged", f"B={b} ragged len 0..{mx} page 256 f16",
                da.flash_decode_paged(*argp, max_length=mx),
                da.flash_decode_paged_plain(*argp, max_length=mx),
                lambda: da.flash_decode_paged(*argp, max_length=mx),
                lambda: da.flash_decode_paged_plain(*argp, max_length=mx), lib,
                nbytes + sum(-(-n // 256) for n in ragged) * 4, flops,
                "F.scaled_dot_product_attention in f16 on the gathered view",
                decode_plan_of("flash_decode_paged", b, nq, nkv, hd, mx, 2, 256))
            del pool
        del cache, k_all, v_all
    s_, start, t = 512, 700, 2048
    cache, q = rnd(2, 1, nkv, t, hd), rnd(1, s_, nq, hd)
    end = start + s_
    k_all, v_all = cache[0, :, :, :end].contiguous(), cache[1, :, :, :end].contiguous()
    qt = q.transpose(1, 2).contiguous()
    mask = (torch.arange(end, device="cuda")[None, :]
            <= (start + torch.arange(s_, device="cuda"))[:, None])
    pairs = s_ * start + s_ * (s_ + 1) // 2
    add("flash_prefill", f"S={s_} start={start} nq={nq} nkv={nkv} f16",
        da.flash_prefill(q, cache, start), da.flash_prefill_plain(q, cache, start),
        lambda: da.flash_prefill(q, cache, start),
        lambda: da.flash_prefill_plain(q, cache, start),
        lambda: F.scaled_dot_product_attention(qt, k_all, v_all, attn_mask=mask,
                                               enable_gqa=True),
        (2 * s_ * nq * hd + 2 * nkv * end * hd) * 2, 4.0 * nq * hd * pairs,
        "F.scaled_dot_product_attention(attn_mask) in f16")


def phase_layer_attention(torch, timer, cases_out):
    """Phase 2, the single-layer attention of the falcon path: K14
    (``flash_decode_layer``) at Falcon-7B's shape (B 1, one kv head, 71 q
    heads, head_dim 64, bf16; lengths 1, 1000 and 2047, read from device
    memory as the served step reads them, the grid planned for the
    length's bucket and split by the length read, bit-equal to the launch
    planned for the length on the host) and at Llama-3-8B's
    (B 1 and 8, 8 kv heads, 4 q heads each, head_dim 128; lengths 1000 and
    4000), and K3 at head_dim 64 at Falcon-7B's shape (S 512 from 0 and
    from 700, S 1000 from 0), each against its plain version; the library
    call is SDPA on the same positions."""
    import torch.nn.functional as F

    from awq_tpu_torch.ops import decode_attn as da
    from awq_tpu_torch.runtime.generate import cache_bucket

    gen = torch.Generator(device="cuda").manual_seed(1357)
    tol = 2.0 ** -6           # bf16 output rounding; K3 rounds P to bf16 too

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def add(name, shape, fn, plain, lib, nbytes, flops, library, plan=None):
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        err, rel = check(f"{name} {shape}", got, ref, tol)
        b_ms, b_by = bound(nbytes, flops)
        cases_out.append(dict(
            name=name, shape=shape, max_abs_err=err, max_rel_err=rel,
            tol=f"{tol:g}*max|ref|", ms=timer(fn), plain_ms=timer(plain, reps=5),
            bound_ms=b_ms, bound_by=b_by, library_ms=timer(lib), library=library,
            **(plan or {})))
        log_case(cases_out[-1])

    fal = FALCON_7B
    for b, nq, nkv, hd, t, lengths in ((1, fal["num_heads"], 1, 64, 2048, (1, 1000, 2047)),
                                       (1, 32, 8, 128, 4096, (1000, 4000)),
                                       (8, 32, 8, 128, 4096, (1000,))):
        kv, q = rnd(2, b, nkv, t, hd), rnd(b, nq, hd)
        for length in lengths:
            k_l, v_l = kv[0, :, :, :length].contiguous(), kv[1, :, :, :length].contiguous()
            n_att, bound_at, where = length, length, ""
            if nkv == 1:
                # falcon's served step: the length in device memory, the
                # grid planned for the burst's bucket, the split by the
                # length read; bit-equal to the host launch planned for
                # the length (forward's)
                bound_at = cache_bucket(t, length)
                n_att = torch.tensor([length], dtype=torch.int32, device="cuda")
                where = f" (device length, bound {bound_at})"
                same = torch.equal(da.flash_decode_layer(q, kv[0], kv[1], n_att, bound_at),
                                   da.flash_decode_layer(q, kv[0], kv[1], length))
                if not same:
                    raise AssertionError(f"flash_decode_layer len={length}: the device-length "
                                         "launch differs from the host launch planned for "
                                         "its length")
                log(f"  flash_decode_layer len={length}: the device-length launch (bound "
                    f"{bound_at}) is bit-equal to the host launch planned for the length; that "
                    f"one {timer(lambda: da.flash_decode_layer(q, kv[0], kv[1], length)):.4f} ms")
            add("flash_decode_layer", f"len={length} B={b} nq={nq} nkv={nkv} hd={hd}{where}",
                lambda: da.flash_decode_layer(q, kv[0], kv[1], n_att, bound_at),
                lambda: da.flash_decode_layer_plain(q, kv[0], kv[1], length),
                lambda: F.scaled_dot_product_attention(q[:, :, None], k_l, v_l,
                                                       enable_gqa=True),
                (2 * b * nq * hd + 2 * b * nkv * length * hd) * 2,
                4.0 * b * nq * length * hd, "F.scaled_dot_product_attention(enable_gqa=True)",
                decode_plan_of("flash_decode_layer", b, nq, nkv, hd, bound_at, 2,
                               by_length=nkv == 1))
            del k_l, v_l
        del kv
    nq, t = fal["num_heads"], 2048
    for s_, start in ((512, 0), (512, 700), (1000, 0)):
        cache, q = rnd(2, 1, 1, t, 64), rnd(1, s_, nq, 64)
        end = start + s_
        k_all, v_all = cache[0, :, :, :end].contiguous(), cache[1, :, :, :end].contiguous()
        qt = q.transpose(1, 2).contiguous()
        mask = (torch.arange(end, device="cuda")[None, :]
                <= (start + torch.arange(s_, device="cuda"))[:, None])
        pairs = s_ * start + s_ * (s_ + 1) // 2
        add("flash_prefill_hd64", f"S={s_} start={start} nq={nq} nkv=1 hd=64",
            lambda: da.flash_prefill(q, cache, start),
            lambda: da.flash_prefill_plain(q, cache, start),
            lambda: F.scaled_dot_product_attention(qt, k_all, v_all, attn_mask=mask,
                                                   enable_gqa=True),
            (2 * s_ * nq * 64 + 2 * end * 64) * 2, 4.0 * nq * 64 * pairs,
            "F.scaled_dot_product_attention(attn_mask, enable_gqa=True)")
        del cache, k_all, v_all


def alibi_bias(torch, slopes, rows, length, relative=False):
    """SDPA's additive mask for ALiBi: ``slope * j`` (``relative``: ``slope *
    (j - i)``) over keys ``j < length`` for query positions ``rows [S]``,
    -inf past each row's causal limit; ``[1, nq, S, length]`` f32."""
    j = torch.arange(length, device="cuda", dtype=torch.float32)
    rel = j[None, :] - (rows[:, None].float() if relative else 0.0)
    bias = slopes[:, None, None] * rel[None]
    return bias.masked_fill(j[None, None, :] > rows[None, :, None].float(), float("-inf"))[None]


def phase_alibi_attention(torch, timer, cases_out):
    """Phase 2, the ALiBi modes (MPT, BLOOM): K2 with slopes at MPT-7B's
    heads (32 q over 32 kv heads, head_dim 128; B 1 at lengths 1000 and
    4000, and 8 ragged rows), K3 with slopes at MPT-7B's heads (S 512 from 0
    and from 700, over a bf16 and an f32 cache) and K14 with slopes at
    BLOOM-560m's (16 heads of 64; lengths 1, 1000 and 2047 read in device
    memory, as the served step reads them) and at 12 heads of 64 (the
    closest-power-of-two slopes), each against its plain version; the library
    call is SDPA with the same bias as an additive mask. Zero slopes give
    each kernel's bits without slopes."""
    import torch.nn.functional as F

    from awq_tpu_torch.models.layers import alibi_slopes
    from awq_tpu_torch.ops import decode_attn as da
    from awq_tpu_torch.runtime.generate import cache_bucket

    gen = torch.Generator(device="cuda").manual_seed(2468)
    tol = 2.0 ** -6           # as the modes without slopes: bf16 output, P in bf16

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def add(name, shape, fn, plain, lib, nbytes, flops, plan=None, zero=None):
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        err, rel = check(f"{name} {shape}", got, ref, tol)
        if zero is not None and not torch.equal(*zero()):
            raise AssertionError(f"{name} {shape}: zero slopes change the output of the "
                                 "launch without slopes")
        b_ms, b_by = bound(nbytes, flops)
        cases_out.append(dict(
            name=name, shape=shape, max_abs_err=err, max_rel_err=rel,
            tol=f"{tol:g}*max|ref|", ms=timer(fn), plain_ms=timer(plain, reps=5),
            bound_ms=b_ms, bound_by=b_by, library_ms=timer(lib),
            library="F.scaled_dot_product_attention(attn_mask=ALiBi bias)", **(plan or {})))
        log_case(cases_out[-1])
        if zero is not None:
            log(f"  {name} {shape}: zero slopes give the bits of the launch without slopes")

    mpt = MPT_7B
    nq, hd = mpt["num_heads"], mpt["head_dim"]
    sl = alibi_slopes(nq, device="cuda")
    zeros = torch.zeros_like(sl)
    for b, lengths in ((1, (1000,)), (1, (4000,)), (8, tuple(RAGGED))):
        t = 4096 if b == 1 else 2048
        cache = rnd(2, b, nq, t, hd)
        q, kn, vn = rnd(b, nq, hd), rnd(b, nq, hd), rnd(b, nq, hd)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        mx = max(lengths)
        k_all = torch.cat([cache[0, :, :, :mx], kn[:, :, None]], dim=2)
        v_all = torch.cat([cache[1, :, :, :mx], vn[:, :, None]], dim=2)
        # SDPA: the current token at column mx, at position len_b
        pos = torch.arange(mx + 1, device="cuda", dtype=torch.float32)[None, :].repeat(b, 1)
        pos[:, mx] = lens.float()
        live = torch.arange(mx + 1, device="cuda")[None, :] < lens[:, None]
        live[:, mx] = True
        mask = (sl[None, :, None] * pos[:, None, :]).masked_fill(
            ~live[:, None, :], float("-inf"))[:, :, None].to(torch.bfloat16)
        shape = (f"len={lengths[0]} B=1" if b == 1 else f"B={b} ragged len 0..{mx}") + \
            f" nq={nq} nkv={nq} hd={hd}"
        add("flash_decode_alibi", shape,
            lambda: da.flash_decode(q, kn, vn, cache, lens, max_length=mx, slopes=sl),
            lambda: da.flash_decode_plain(q, kn, vn, cache, lens, max_length=mx, slopes=sl),
            lambda: F.scaled_dot_product_attention(q[:, :, None], k_all, v_all, attn_mask=mask),
            (2 * b * nq * hd + 2 * b * nq * hd + 2 * nq * hd * sum(lengths)) * 2 + nq * 4
            + appended(b, nq, hd, 2),
            4.0 * nq * hd * (sum(lengths) + b),
            decode_plan_of("flash_decode", b, nq, nq, hd, mx, 2),
            zero=(lambda: (da.flash_decode(q, kn, vn, cache, lens, max_length=mx,
                                           slopes=zeros),
                           da.flash_decode(q, kn, vn, cache, lens, max_length=mx)))
            if b == 1 and lengths[0] == 1000 else None)
        del cache, k_all, v_all
    for dtype in (torch.bfloat16, torch.float32):
        for s_, start in ((512, 0), (512, 700)):
            cache, q = rnd(2, 1, nq, 2048, hd, dtype=dtype), rnd(1, s_, nq, hd, dtype=dtype)
            end = start + s_
            k_all, v_all = cache[0, :, :, :end].contiguous(), cache[1, :, :, :end].contiguous()
            qt = q.transpose(1, 2).contiguous()
            mask = alibi_bias(torch, sl, start + torch.arange(s_, device="cuda"), end, True)
            pairs = s_ * start + s_ * (s_ + 1) // 2
            es = 2 if dtype == torch.bfloat16 else 4
            add("flash_prefill_alibi",
                f"S={s_} start={start} nq={nq} nkv={nq} {str(dtype)[6:]}",
                lambda: da.flash_prefill(q, cache, start, slopes=sl),
                lambda: da.flash_prefill_plain(q, cache, start, slopes=sl),
                lambda: F.scaled_dot_product_attention(qt, k_all, v_all, attn_mask=mask.to(dtype)),
                (2 * s_ * nq * hd + 2 * nq * end * hd) * es + nq * 4, 4.0 * nq * hd * pairs,
                zero=(lambda: (da.flash_prefill(q, cache, start, slopes=zeros),
                               da.flash_prefill(q, cache, start))) if start == 700 else None)
            del cache, k_all, v_all
    for nq_l, lengths in ((BLOOM_560M["num_heads"], (1, 1000, 2047)), (12, (1000,))):
        hd_l, t = 64, 2048
        sl_l = alibi_slopes(nq_l, device="cuda")
        kv, q = rnd(2, 1, nq_l, t, hd_l), rnd(1, nq_l, hd_l)
        for length in lengths:
            # the served step's length in device memory, the grid planned for
            # its bucket: the bits of the host launch planned for the length
            bucket = cache_bucket(t, length)
            n_dev = torch.tensor([length], dtype=torch.int32, device="cuda")
            same = torch.equal(da.flash_decode_layer(q, kv[0], kv[1], n_dev, bucket, slopes=sl_l),
                               da.flash_decode_layer(q, kv[0], kv[1], length, slopes=sl_l))
            if not same:
                raise AssertionError(f"flash_decode_layer_alibi len={length}: the device-length "
                                     "launch differs from the host launch planned for its "
                                     "length")
            k_l, v_l = kv[0, :, :, :length].contiguous(), kv[1, :, :, :length].contiguous()
            mask = alibi_bias(torch, sl_l, torch.tensor([length - 1], device="cuda"), length)
            add("flash_decode_layer_alibi",
                f"len={length} B=1 nq={nq_l} nkv={nq_l} hd={hd_l} (device length, bound "
                f"{bucket})",
                lambda: da.flash_decode_layer(q, kv[0], kv[1], n_dev, bucket, slopes=sl_l),
                lambda: da.flash_decode_layer_plain(q, kv[0], kv[1], length, slopes=sl_l),
                lambda: F.scaled_dot_product_attention(q[:, :, None], k_l, v_l,
                                                       attn_mask=mask.to(torch.bfloat16)),
                (2 * nq_l * hd_l + 2 * nq_l * length * hd_l) * 2 + nq_l * 4,
                4.0 * nq_l * length * hd_l,
                decode_plan_of("flash_decode_layer", 1, nq_l, nq_l, hd_l, bucket, 2,
                               by_length=True),
                zero=(lambda: (da.flash_decode_layer(q, kv[0], kv[1], length,
                                                     slopes=torch.zeros_like(sl_l)),
                               da.flash_decode_layer(q, kv[0], kv[1], length)))
                if length == 1000 else None)
            del k_l, v_l
        del kv


def decode_mask(torch, lens, mx, slopes=None):
    """SDPA's additive mask for a decode step whose current token sits at
    column ``mx`` (after the ``mx`` cached columns): -inf past each row's
    length, and with ALiBi ``slopes [nq]`` the bias ``slope * j``, the
    current token's at ``j = len_b``. ``[B, nq or 1, 1, mx + 1]`` bf16."""
    b = lens.shape[0]
    live = torch.arange(mx + 1, device="cuda")[None, :] < lens[:, None]
    live[:, mx] = True
    if slopes is None:
        bias = torch.zeros((b, 1, mx + 1), device="cuda")
    else:
        pos = torch.arange(mx + 1, device="cuda", dtype=torch.float32)[None, :].repeat(b, 1)
        pos[:, mx] = lens.float()
        bias = slopes[None, :, None] * pos[:, None, :]
    return bias.masked_fill(~live[:, None, :], float("-inf"))[:, :, None].to(torch.bfloat16)


def phase_family_attention(torch, timer, cases_out):
    """Phase 2, the batched, paged and int8 steps of falcon, MPT and BLOOM:
    K2, K8 and K9 at Falcon-7B's heads (71 q heads over one kv head at
    head_dim 64: the unit ``decode_attn_wide``) on K2's 8 ragged rows (K8
    over a permuted pool of pages of 256, its output equal to K2's bit for
    bit; K9 over int8 codes, K2 on the dequantized cache beside it); K8 and
    K9 with ALiBi slopes at MPT-7B's 32 heads of 128 and BLOOM-560m's 16 of
    64, and K2 with slopes at BLOOM-560m's, on the same rows; K7's int8 mode
    at head_dim 64 (Falcon-7B's one kv head, 32 layers, 8 rows), exact. Each
    against its plain version at 2^-6 of the largest value; the library call
    is SDPA on the same positions (the bias as an additive mask; over the
    gathered or dequantized view)."""
    import torch.nn.functional as F

    from awq_tpu_torch.models.layers import alibi_slopes
    from awq_tpu_torch.ops import cache_append as ca
    from awq_tpu_torch.ops import decode_attn as da

    gen = torch.Generator(device="cuda").manual_seed(97531)
    tol = 2.0 ** -6           # bf16 output rounding, sums in other orders
    b, mx, t = len(RAGGED), max(RAGGED), 2048
    lens = torch.tensor(RAGGED, dtype=torch.int32, device="cuda")
    n_pos = sum(RAGGED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def add(name, shape, fn, plain, lib, nbytes, flops, library, plan, extra=None):
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        err, rel = check(f"{name} {shape}", got, ref, tol)
        b_ms, b_by = bound(nbytes, flops)
        cases_out.append(dict(
            name=name, shape=shape, max_abs_err=err, max_rel_err=rel,
            tol=f"{tol:g}*max|ref|", ms=timer(fn), plain_ms=timer(plain, reps=5),
            bound_ms=b_ms, bound_by=b_by, library_ms=timer(lib), library=library,
            **plan, **(extra or {})))
        log_case(cases_out[-1])
        return got

    def sdpa(q, k_all, v_all, mask, gqa):
        return lambda: F.scaled_dot_product_attention(q[:, :, None], k_all, v_all,
                                                      attn_mask=mask, enable_gqa=gqa)

    # (label, nq, nkv, hd, slopes): Falcon-7B without slopes; MPT-7B and
    # BLOOM-560m with them
    for fam, nq, nkv, hd, alibi in (("Falcon-7B", FALCON_7B["num_heads"], 1, 64, False),
                                    ("MPT-7B", MPT_7B["num_heads"], MPT_7B["num_heads"], 128,
                                     True),
                                    ("BLOOM-560m", BLOOM_560M["num_heads"],
                                     BLOOM_560M["num_heads"], 64, True)):
        sl = alibi_slopes(nq, device="cuda") if alibi else None
        tag = "_alibi" if alibi else "_wide"
        shape = f"{fam} B={b} ragged len 0..{mx} nq={nq} nkv={nkv} hd={hd}"
        cache = rnd(2, b, nkv, t, hd)
        q, kn, vn = rnd(b, nq, hd), rnd(b, nkv, hd), rnd(b, nkv, hd)
        k_all = torch.cat([cache[0, :, :, :mx], kn[:, :, None]], dim=2)
        v_all = torch.cat([cache[1, :, :, :mx], vn[:, :, None]], dim=2)
        mask = decode_mask(torch, lens, mx, sl)
        lib = sdpa(q, k_all, v_all, mask, nkv != nq)
        library = ("F.scaled_dot_product_attention(attn_mask=ALiBi bias)" if alibi else
                   "F.scaled_dot_product_attention(attn_mask, enable_gqa=True)")
        kv_bytes = ((2 * b * nq * hd + 2 * b * nkv * hd + 2 * nkv * hd * n_pos) * 2
                    + appended(b, nkv, hd, 2))
        flops = 4.0 * nq * hd * (n_pos + b)
        k2 = None
        if fam != "MPT-7B":    # K2 with slopes at MPT-7B's heads: phase_alibi_attention
            k2 = add("flash_decode" + tag, shape,
                     lambda: da.flash_decode(q, kn, vn, cache, lens, max_length=mx, slopes=sl),
                     lambda: da.flash_decode_plain(q, kn, vn, cache, lens, max_length=mx,
                                                   slopes=sl),
                     lib, kv_bytes + (nq * 4 if alibi else 0), flops, library,
                     decode_plan_of("flash_decode", b, nq, nkv, hd, mx, 2))
        pool, tables = scatter_pages(torch, cache[None], t // PAGE, PAGE, gen,
                                     need=[-(-(n + 1) // PAGE) for n in RAGGED])
        k8 = add("flash_decode_paged" + tag, shape + f" page {PAGE}",
                 lambda: da.flash_decode_paged(q, kn, vn, pool, tables, 0, lens, max_length=mx,
                                               slopes=sl),
                 lambda: da.flash_decode_paged_plain(q, kn, vn, pool, tables, 0, lens,
                                                     max_length=mx, slopes=sl),
                 lib, kv_bytes + sum(-(-n // PAGE) for n in RAGGED) * 4
                 + (nq * 4 if alibi else 0), flops, library,
                 decode_plan_of("flash_decode_paged", b, nq, nkv, hd, mx, 2, PAGE))
        if k2 is None:
            k2 = da.flash_decode(q, kn, vn, cache, lens, max_length=mx, slopes=sl)
        if not torch.equal(k8, k2):
            raise AssertionError(f"flash_decode_paged{tag} {shape}: pages of {PAGE} do not "
                                 "give K2's output bit for bit")
        log(f"  flash_decode_paged{tag} {fam}: pages of {PAGE} give K2's output bit for bit")
        del pool, tables
        codes, scales = ca.quantize_kv(cache.float())
        deq = ca.dequantize_kv(codes, scales, torch.bfloat16)
        kq_all = torch.cat([deq[0, :, :, :mx], kn[:, :, None]], dim=2)
        vq_all = torch.cat([deq[1, :, :, :mx], vn[:, :, None]], dim=2)
        on_deq = da.flash_decode(q, kn, vn, deq, lens, max_length=mx, slopes=sl)
        k2_ms = timer(lambda: da.flash_decode(q, kn, vn, deq, lens, max_length=mx, slopes=sl))
        got9 = da.flash_decode_int8(q, kn, vn, codes, scales, lens, max_length=mx, slopes=sl)
        vs_k2, _ = check(f"flash_decode_int8{tag} against K2 on the dequantized cache", got9,
                         on_deq, tol)
        add("flash_decode_int8" + tag, shape,
            lambda: da.flash_decode_int8(q, kn, vn, codes, scales, lens, max_length=mx,
                                         slopes=sl),
            lambda: da.flash_decode_int8_append_plain(q, kn, vn, codes, scales, lens,
                                                      max_length=mx, slopes=sl),
            sdpa(q, kq_all, vq_all, mask, nkv != nq),
            (2 * b * nq * hd + 2 * b * nkv * hd) * 2 + 2 * nkv * n_pos * (hd + 4)
            + (nq * 4 if alibi else 0) + appended(b, nkv, hd, 1), flops,
            library + " on the dequantized bf16 view",
            decode_plan_of("flash_decode_int8", b, nq, nkv, hd, mx, 1),
            dict(yardstick_ms=k2_ms,
                 yardstick=f"K2 on the dequantized bf16 cache (max diff {vs_k2:.2e})"))
        del cache, codes, scales, deq, k_all, v_all, kq_all, vq_all

    # K7's int8 mode at head_dim 64: one step's k/v of Falcon-7B's 32 layers
    # (one kv head) quantized into an 8-slot int8 cache at the ragged rows'
    # lengths; exact, K7 on a bf16 cache of the same rows beside it
    n_l, nkv, hd = FALCON_7B["num_layers"], 1, 64
    codes = torch.randint(-127, 128, (n_l, 2, b, nkv, t, hd), generator=gen,
                          dtype=torch.int8, device="cuda")
    scales = torch.rand((n_l, 2, b, nkv, t), generator=gen, device="cuda") * 0.03
    c8 = [(codes, scales), (codes.clone(), scales.clone())]
    kv = torch.randn((n_l, 2, b, nkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    kv[0, 1, 2, 0] = 0.0                                  # a zero row: the 1e-6 floor
    ca.batched_cache_append_int8(*c8[0], kv, lens)
    ca.batched_cache_append_int8_plain(*c8[1], kv, lens)
    torch.cuda.synchronize()
    if not (torch.equal(c8[0][0], c8[1][0]) and torch.equal(c8[0][1], c8[1][1])):
        raise AssertionError("cache_append_int8 hd=64: the kernel's codes or scales differ "
                             "from the plain version's")
    cache16 = torch.zeros((n_l, 2, b, nkv, t, hd), dtype=torch.bfloat16, device="cuda")
    rows_kv = kv.numel() // hd
    b_ms, b_by = bound(kv.numel() * 2 + kv.numel() + rows_kv * 4 + b * 4, 0.0)
    cases_out.append(dict(
        name="cache_append_int8_hd64", shape=f"L={n_l} B={b} nkv={nkv} hd={hd} T={t}",
        max_abs_err=0.0, max_rel_err=0.0, tol="exact",
        ms=timer(lambda: ca.batched_cache_append_int8(*c8[0], kv, lens)),
        plain_ms=timer(lambda: ca.batched_cache_append_int8_plain(*c8[1], kv, lens), reps=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, library="none",
        yardstick_ms=timer(lambda: ca.batched_cache_append(cache16, kv, lens)),
        yardstick="K7 on a bf16 cache, same rows"))
    log_case(cases_out[-1])
    del codes, scales, c8, cache16


def repair_pair(da, kern, q, kn, vn, cache, codes, scales, lens1, length, t):
    """The host launch planned for ``length`` and the launch whose grid is
    planned for the bucket ``t - 1`` (``t`` for K14, whose length counts the
    current token) and which splits by the length it reads, of K2, K9 or
    K14: two callables."""
    if kern == "K2":
        return (lambda: da.flash_decode(q, kn, vn, cache, lens1, max_length=length),
                lambda: da.flash_decode(q, kn, vn, cache, lens1, max_length=t - 1,
                                        by_length=True))
    if kern == "K9":
        return (lambda: da.flash_decode_int8(q, kn, vn, codes, scales, lens1,
                                             max_length=length),
                lambda: da.flash_decode_int8(q, kn, vn, codes, scales, lens1,
                                             max_length=t - 1, by_length=True))
    return (lambda: da.flash_decode_layer(q, cache[0], cache[1], length),
            lambda: da.flash_decode_layer(q, cache[0], cache[1], lens1, t))

def phase_new_family_attention(torch, timer, cases_out):
    """Phase 2, the attention of phase 3l's families and the repair of the
    device-length split. At StarCoder's heads (48 q heads over ONE kv head at
    head_dim 128): K14 at B 1 over lengths 1, 1000 and 2047 read in device
    memory, the grid planned for the length's bucket (the served step); K2,
    K8 (pages of 256: K2's output bit for bit) and K9 in the unit
    ``decode_attn_wide`` on K2's 8 ragged rows; K3 at S 512 from 0 and from
    700. K2 at OPT-6.7B's and Pythia-6.9B's heads (32 q over 32 kv heads of
    128) at B 1 and length 1000 read in device memory. Each against its
    plain version at 2^-6 of the largest value, SDPA beside it. Then the
    repair: K2 and K9 at Llama-3-8B's and OPT-6.7B's heads and K14 at
    Falcon-7B's and StarCoder's, their lengths in device memory and their
    grids planned for the bucket 2047 (or 2048), each bit-equal to the host
    launch planned for its length at lengths 1, 255, 1000 and 2047; the two
    launches' times are printed."""
    import torch.nn.functional as F

    from awq_tpu_torch.ops import cache_append as ca
    from awq_tpu_torch.ops import decode_attn as da
    from awq_tpu_torch.runtime.generate import cache_bucket

    gen = torch.Generator(device="cuda").manual_seed(24680)
    tol = 2.0 ** -6           # bf16 output rounding, sums in other orders

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def add(name, shape, fn, plain, lib, nbytes, flops, library, plan, extra=None):
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        err, rel = check(f"{name} {shape}", got, ref, tol)
        b_ms, b_by = bound(nbytes, flops)
        cases_out.append(dict(
            name=name, shape=shape, max_abs_err=err, max_rel_err=rel,
            tol=f"{tol:g}*max|ref|", ms=timer(fn), plain_ms=timer(plain, reps=5),
            bound_ms=b_ms, bound_by=b_by, library_ms=timer(lib), library=library,
            **plan, **(extra or {})))
        log_case(cases_out[-1])
        return got

    nq, nkv, hd, t = STARCODER["num_heads"], 1, 128, 2048
    sc = f"StarCoder nq={nq} nkv={nkv} hd={hd}"
    kv, q1 = rnd(2, 1, nkv, t, hd), rnd(1, nq, hd)
    for length in (1, 1000, 2047):
        bucket = cache_bucket(t, length)
        n_dev = torch.tensor([length], dtype=torch.int32, device="cuda")
        k_l, v_l = kv[0, :, :, :length].contiguous(), kv[1, :, :, :length].contiguous()
        add("flash_decode_layer_starcoder", f"{sc} B=1 len={length} (device length, bound "
            f"{bucket})",
            lambda: da.flash_decode_layer(q1, kv[0], kv[1], n_dev, bucket),
            lambda: da.flash_decode_layer_plain(q1, kv[0], kv[1], length),
            lambda: F.scaled_dot_product_attention(q1[:, :, None], k_l, v_l, enable_gqa=True),
            (2 * nq * hd + 2 * nkv * length * hd) * 2, 4.0 * nq * length * hd,
            "F.scaled_dot_product_attention(enable_gqa=True)",
            decode_plan_of("flash_decode_layer", 1, nq, nkv, hd, bucket, 2, by_length=True))
        del k_l, v_l
    b, mx = len(RAGGED), max(RAGGED)
    lens = torch.tensor(RAGGED, dtype=torch.int32, device="cuda")
    n_pos = sum(RAGGED)
    cache = rnd(2, b, nkv, t, hd)
    q, kn, vn = rnd(b, nq, hd), rnd(b, nkv, hd), rnd(b, nkv, hd)
    k_all = torch.cat([cache[0, :, :, :mx], kn[:, :, None]], dim=2)
    v_all = torch.cat([cache[1, :, :, :mx], vn[:, :, None]], dim=2)
    mask = decode_mask(torch, lens, mx)

    def sdpa(kk, vv):
        return lambda: F.scaled_dot_product_attention(q[:, :, None], kk, vv, attn_mask=mask,
                                                      enable_gqa=True)

    library = "F.scaled_dot_product_attention(attn_mask, enable_gqa=True)"
    shape = f"{sc} B={b} ragged len 0..{mx}"
    kv_bytes = ((2 * b * nq * hd + 2 * b * nkv * hd + 2 * nkv * hd * n_pos) * 2
                + appended(b, nkv, hd, 2))
    flops = 4.0 * nq * hd * (n_pos + b)
    k2 = add("flash_decode_wide_starcoder", shape,
             lambda: da.flash_decode(q, kn, vn, cache, lens, max_length=mx),
             lambda: da.flash_decode_plain(q, kn, vn, cache, lens, max_length=mx),
             sdpa(k_all, v_all), kv_bytes, flops, library,
             decode_plan_of("flash_decode", b, nq, nkv, hd, mx, 2))
    pool, tables = scatter_pages(torch, cache[None], t // PAGE, PAGE, gen,
                                 need=[-(-(n + 1) // PAGE) for n in RAGGED])
    k8 = add("flash_decode_paged_wide_starcoder", shape + f" page {PAGE}",
             lambda: da.flash_decode_paged(q, kn, vn, pool, tables, 0, lens, max_length=mx),
             lambda: da.flash_decode_paged_plain(q, kn, vn, pool, tables, 0, lens,
                                                 max_length=mx),
             sdpa(k_all, v_all), kv_bytes + sum(-(-n // PAGE) for n in RAGGED) * 4, flops,
             library, decode_plan_of("flash_decode_paged", b, nq, nkv, hd, mx, 2, PAGE))
    if not torch.equal(k8, k2):
        raise AssertionError(f"flash_decode_paged_wide {sc}: pages of {PAGE} do not give "
                             "K2's output bit for bit")
    log(f"  flash_decode_paged_wide {sc}: pages of {PAGE} give K2's output bit for bit")
    del pool, tables
    codes, scales = ca.quantize_kv(cache.float())
    deq = ca.dequantize_kv(codes, scales, torch.bfloat16)
    kq_all = torch.cat([deq[0, :, :, :mx], kn[:, :, None]], dim=2)
    vq_all = torch.cat([deq[1, :, :, :mx], vn[:, :, None]], dim=2)
    k2_ms = timer(lambda: da.flash_decode(q, kn, vn, deq, lens, max_length=mx))
    add("flash_decode_int8_wide_starcoder", shape,
        lambda: da.flash_decode_int8(q, kn, vn, codes, scales, lens, max_length=mx),
        lambda: da.flash_decode_int8_plain(q, kn, vn, codes, scales, lens, max_length=mx),
        sdpa(kq_all, vq_all), (2 * b * nq * hd + 2 * b * nkv * hd) * 2
        + 2 * nkv * n_pos * (hd + 4) + appended(b, nkv, hd, 1), flops,
        library + " on the dequantized bf16 view",
        decode_plan_of("flash_decode_int8", b, nq, nkv, hd, mx, 1),
        dict(yardstick_ms=k2_ms, yardstick="K2 on the dequantized bf16 cache"))
    del cache, codes, scales, deq, k_all, v_all, kq_all, vq_all
    for s_, start in ((512, 0), (512, 700)):
        cache, qp = rnd(2, 1, nkv, t, hd), rnd(1, s_, nq, hd)
        end = start + s_
        k_e, v_e = cache[0, :, :, :end].contiguous(), cache[1, :, :, :end].contiguous()
        qt = qp.transpose(1, 2).contiguous()
        causal = (torch.arange(end, device="cuda")[None, :]
                  <= (start + torch.arange(s_, device="cuda"))[:, None])
        pairs = s_ * start + s_ * (s_ + 1) // 2
        add("flash_prefill_starcoder", f"S={s_} start={start} {sc}",
            lambda: da.flash_prefill(qp, cache, start),
            lambda: da.flash_prefill_plain(qp, cache, start),
            lambda: F.scaled_dot_product_attention(qt, k_e, v_e, attn_mask=causal,
                                                   enable_gqa=True),
            (2 * s_ * nq * hd + 2 * end * nkv * hd) * 2, 4.0 * nq * hd * pairs,
            "F.scaled_dot_product_attention(attn_mask, enable_gqa=True)", {})
        del cache, k_e, v_e

    # K2 at OPT-6.7B's and Pythia-6.9B's heads, their served step: B 1, the
    # length in device memory, the grid planned for the bucket
    nq, nkv, length = OPT_6_7B["num_heads"], OPT_6_7B["num_kv_heads"], 1000
    bucket = cache_bucket(t, length + 1) - 1
    cache, q, kn, vn = rnd(2, 1, nkv, t, hd), rnd(1, nq, hd), rnd(1, nkv, hd), rnd(1, nkv, hd)
    lens1 = torch.tensor([length], dtype=torch.int32, device="cuda")
    k_all = torch.cat([cache[0, :, :, :length], kn[:, :, None]], dim=2)
    v_all = torch.cat([cache[1, :, :, :length], vn[:, :, None]], dim=2)
    add("flash_decode_opt", f"OPT-6.7B nq={nq} nkv={nkv} hd={hd} B=1 len={length} (device "
        f"length, bound {bucket})",
        lambda: da.flash_decode(q, kn, vn, cache, lens1, max_length=bucket, by_length=True),
        lambda: da.flash_decode_plain(q, kn, vn, cache, lens1, max_length=length),
        lambda: F.scaled_dot_product_attention(q[:, :, None], k_all, v_all),
        (2 * nq * hd + 2 * nkv * hd + 2 * nkv * length * hd) * 2 + appended(1, nkv, hd, 2),
        4.0 * nq * hd * (length + 1), "F.scaled_dot_product_attention",
        decode_plan_of("flash_decode", 1, nq, nkv, hd, bucket, 2, by_length=True))
    del cache, k_all, v_all

    # the repair: a launch planned for the bucket that splits by the length
    # it reads, bit-equal to the launch planned on the host for the length
    for kern, nq, nkv, hd in (("K2", 32, 8, 128), ("K2", 32, 32, 128), ("K9", 32, 8, 128),
                              ("K9", 32, 32, 128), ("K14", FALCON_7B["num_heads"], 1, 64),
                              ("K14", STARCODER["num_heads"], 1, 128)):
        cache, q, kn, vn = rnd(2, 1, nkv, t, hd), rnd(1, nq, hd), rnd(1, nkv, hd), rnd(1, nkv, hd)
        codes, scales = ca.quantize_kv(cache.float()) if kern == "K9" else (None, None)
        times = []
        for length in (1, 255, 1000, 2047):
            lens1 = torch.tensor([length], dtype=torch.int32, device="cuda")
            host, dev = repair_pair(da, kern, q, kn, vn, cache, codes, scales, lens1, length, t)
            a, d = host(), dev()
            torch.cuda.synchronize()
            if not torch.equal(a, d):
                raise AssertionError(f"{kern} nq={nq} nkv={nkv} hd={hd} len={length}: the "
                                     "launch split by the length it reads differs from the "
                                     "host launch planned for the length")
            times.append(f"{length}: {timer(host):.4f} / {timer(dev):.4f}")
        log(f"  {kern} nq={nq} nkv={nkv} hd={hd}: the device-length launch planned for the "
            f"bucket {t if kern == 'K14' else t - 1} is bit-equal to the host launch planned "
            "for the length at lengths 1, 255, 1000, 2047; ms host / device by length: "
            + ", ".join(times))
        del cache, codes, scales


VERIFY_W = 8            # phase 2's and 3m's window: k = 7 drafts and the last token


def phase_verify_attention(torch, timer, cases_out):
    """Phase 2, the window mode of K2 and K9 (``flash_verify``,
    ``flash_verify_int8``; ``verify_step_batched``'s attention, XLA in the JAX
    package: no TPU kernel): W = 8 queries a row over the row's prefix and
    its causal window, at Llama-3-8B's heads (32 q over 8 kv, head_dim 128)
    at B = 1, lengths 1000 and 4000, and on K2's 8 ragged rows, and at
    Falcon-7B's (71 q over ONE kv head, head_dim 64) on the 8 rows; over
    bf16, f16 and int8 caches. Each row's output within 2^-6 of that row's
    largest magnitude in the plain version (a row at length 0 attends its
    window alone, many times the magnitude of a row over ~1000 positions);
    the cache the launch wrote (the window at each row's
    length) bit-equal to the plain append's, codes and scales included, and
    nothing else of it touched. Yardsticks: SDPA with the prefix-and-causal
    mask on the (dequantized) cache, and K2 (K9 over int8) on the same rows
    with one query a row."""
    import torch.nn.functional as F

    from awq_tpu_torch.ops import cache_append as ca
    from awq_tpu_torch.ops import decode_attn as da

    gen = torch.Generator(device="cuda").manual_seed(4321)
    tol = 2.0 ** -6               # bf16/f16 outputs, P rounded for P.V, other orders
    w = VERIFY_W
    shapes = [("Llama-3-8B", LLAMA3_8B, [1000], 4096), ("Llama-3-8B", LLAMA3_8B, [4000], 4096),
              ("Llama-3-8B", LLAMA3_8B, RAGGED, 2048), ("Falcon-7B", FALCON_7B, RAGGED, 2048)]
    for model, cfg, ragged, t in shapes:
        nq, nkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
        b, mx = len(ragged), max(ragged)
        lens = torch.tensor(ragged, dtype=torch.int32, device="cuda")
        what = f"W={w} len={mx}" if b == 1 else f"W={w} B={b} ragged len 0..{mx}"
        for dt in ("bf16", "f16", "int8"):
            int8 = dt == "int8"
            qdt = torch.float16 if dt == "f16" else torch.bfloat16
            rnd = lambda *sh: torch.randn(sh, generator=gen, device="cuda")  # noqa: E731
            q = rnd(b, w, nq, hd).to(qdt)
            kn, vn = rnd(b, w, nkv, hd).to(qdt), rnd(b, w, nkv, hd).to(qdt)
            if int8:
                codes, scales = ca.quantize_kv(rnd(2, b, nkv, t, hd))
                deq = ca.dequantize_kv(codes, scales, qdt)
                got_c, ref_c = (codes.clone(), scales.clone()), (codes.clone(), scales.clone())
                got = da.flash_verify_int8(q, kn, vn, *got_c, lens, max_length=mx)
                ref = da.flash_verify_int8_append_plain(q, kn, vn, *ref_c, lens,
                                                        max_length=mx)
                run = lambda: da.flash_verify_int8(q, kn, vn, codes, scales,  # noqa: E731
                                                   lens, max_length=mx)
                plain = lambda: da.flash_verify_int8_append_plain(  # noqa: E731
                    q, kn, vn, codes, scales, lens, max_length=mx)
                k2 = lambda: da.flash_decode_int8(  # noqa: E731
                    q[:, 0].contiguous(), kn[:, 0].contiguous(), vn[:, 0].contiguous(), codes,
                    scales, lens, max_length=mx)
                same = torch.equal(got_c[0], ref_c[0]) and torch.equal(got_c[1], ref_c[1])
                esize = 1
            else:
                cache = rnd(2, b, nkv, t, hd).to(qdt)
                deq = cache
                got_c, ref_c = cache.clone(), cache.clone()
                got = da.flash_verify(q, kn, vn, got_c, lens, max_length=mx)
                ref = da.flash_verify_append_plain(q, kn, vn, ref_c, lens, max_length=mx)
                run = lambda: da.flash_verify(q, kn, vn, cache, lens,  # noqa: E731
                                              max_length=mx)
                plain = lambda: da.flash_verify_append_plain(  # noqa: E731
                    q, kn, vn, cache, lens, max_length=mx)
                k2 = lambda: da.flash_decode(  # noqa: E731
                    q[:, 0].contiguous(), kn[:, 0].contiguous(), vn[:, 0].contiguous(), cache,
                    lens, max_length=mx)
                same = torch.equal(got_c, ref_c)
                esize = 2
            torch.cuda.synchronize()
            name = "flash_verify_int8" if int8 else "flash_verify"
            label = f"{name} {model} {what} {dt}"
            err, rel = check_rows(label, got, ref, tol)
            if not same:
                raise AssertionError(f"{label}: the written cache differs from the plain "
                                     "append's")
            # SDPA over the prefix [0, mx) and the window, each row's mask:
            # t < len_b on the prefix, j <= i in the window
            k_all = torch.cat([deq[0, :, :, :mx], kn.transpose(1, 2)], dim=2)
            v_all = torch.cat([deq[1, :, :, :mx], vn.transpose(1, 2)], dim=2)
            mask = torch.cat([
                (torch.arange(mx, device="cuda")[None, :] < lens[:, None])[:, None, :]
                .expand(b, w, mx),
                torch.ones((w, w), dtype=torch.bool, device="cuda").tril()[None].expand(b, w, w)],
                dim=2)[:, None]
            qt = q.transpose(1, 2)
            ms = timer(run)
            plain_ms = timer(plain, reps=5)
            lib_ms = timer(lambda: F.scaled_dot_product_attention(qt, k_all, v_all,
                                                                  attn_mask=mask,
                                                                  enable_gqa=True))
            k2_ms = timer(k2)
            rows = sum(ragged)
            prefix = 2 * nkv * rows * (hd * esize + (4 if int8 else 0))
            window = 2 * b * w * nkv * hd * 2                 # read, q's dtype
            written = 2 * b * w * nkv * (hd * esize + (4 if int8 else 0))
            nbytes = 2 * b * w * nq * hd * 2 + window + prefix + written
            flops = 4.0 * nq * hd * (w * rows + b * w * (w + 1) // 2)
            b_ms, b_by = bound(nbytes, flops)
            plan = da.verify_plan(b, w, nq, nkv, hd, mx, esize,
                                  sms=torch.cuda.get_device_properties(0).multi_processor_count)
            cases_out.append(dict(
                name=name, shape=f"{what} {model} nq={nq} nkv={nkv} hd={hd} {dt}",
                max_abs_err=err, max_rel_err=rel, tol=f"{tol:g}*max|ref| of each row", ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                library="F.scaled_dot_product_attention(prefix-and-causal mask, enable_gqa) on "
                        "the " + ("dequantized " if int8 else "") + "cache",
                yardstick_ms=k2_ms,
                yardstick=("K9" if int8 else "K2") + " on the same rows, one query a row",
                plan=plan.describe(), written="bit-equal to the plain append"))
            log_case(cases_out[-1])
            del got_c, ref_c, deq, k_all, v_all
            if int8:
                del codes, scales
            else:
                del cache


def zero_mean(params, w_bit: int):
    """``init_qparams``' random layers with their zero points at the codes'
    mean, (2^w_bit - 1) / 2, so that the weights have zero mean, as a trained
    model's are near. At the zero point 2^(w_bit - 1) the mean weight is -s/2:
    every down output of an MPT layer then carries -s/2 times the sum of the
    GELU's mostly positive outputs, the residual gathers a common mode of
    -244 against a spread of 9 over 32 layers at MPT-7B's intermediate width
    (``scripts/exp_mpt_conditioning.py``, H 1024, I 16384), which LayerNorm
    subtracts, leaving bf16's rounding of the residual a large share of the
    rest: one input element moved by one bf16 step then moves layer 31's k by
    24% of its largest, and any two implementations part as far; with zero-
    mean weights by 1.4%."""
    from awq_tpu_torch.ops.w4a16 import QLinear

    for p in params["layers"].values():
        if isinstance(p, QLinear):
            p.szeros.copy_(p.scales * ((2 ** w_bit - 1) / 2))
    return params


def phase_mpt_megakernels(torch, timer, cases_out):
    """Phase 2, K4's MPT shape at MPT-7B's widths (32 layers, random
    zero-mean weights and head from a seed, ``zero_mean``), in W4 and in W3: the layer entry at layer 5 over
    lengths 0, 1000 and 4000, and the token entry over 32 layers and the
    head at length 1000 with its position in device memory (the workspace
    for the 2048-position bucket), held to the plain version and, bit for
    bit, to the launch given the length as a host int; the yardstick is the
    stacked path's device time for the same step (K1's GEMV, K2 with
    slopes and the glue)."""
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama
    from awq_tpu_torch.ops import megakernel as mk

    cfg = ModelConfig(**MPT_7B)
    h_dim, nq, hd, L, vocab = (cfg.hidden_size, cfg.num_heads, cfg.head_dim,
                               cfg.num_layers, cfg.vocab_size)
    t_cache = 4096 + 64
    tol_layer, tol_deep = 2.0 ** -6, 5e-2      # as the llama shape's cases
    for w3 in (False, True):
        sfx, wname = ("_w3", "W3") if w3 else ("", "W4")
        gen = torch.Generator(device="cuda").manual_seed(1357 + w3)
        params = zero_mean(llama.init_qparams(cfg, QuantConfig(w_bit=3 if w3 else 4,
                                                               group_size=G), gen), 3 if w3 else 4)
        params["lm_head"] = params["embed"].T.contiguous()       # the tied head, quantized
        params = llama.fuse_linears(llama.quantize_head(params, cfg), cfg)
        la = params["layers"]
        lins = (la["wqkv"], la["wo"], la["up"], la["down"])
        args = lins + (la["ln1"], la["ln2"], None, None)
        cache = llama.init_kv_cache(cfg, 1, t_cache)
        cache.normal_(generator=gen)
        layer_bytes = sum(qlinear_bytes(p, 0) for p in lins) + 2 * h_dim * 2
        layer_flops = 2 * sum(p.in_features * p.out_features for p in lins)
        kv_pos = 2 * nq * hd * 2
        head = dict(whead=params["lm_head"], norm_w=params["norm"], shape="mpt")

        def record(name, shape, got, ref, tol, ms, plain_ms, yard_ms, nbytes, flops):
            err = rel = 0.0
            for i, (g_, r_) in enumerate(zip(got, ref)):
                e, r2 = check(f"{name} {shape} output {i}", g_, r_, tol)
                err, rel = max(err, e), max(rel, r2)
            b_ms, b_by = bound(nbytes, flops)
            cases_out.append(dict(
                name=name, shape=shape, max_abs_err=err, max_rel_err=rel,
                tol=f"{tol:g}*max|ref|", ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, library="none", yardstick_ms=yard_ms,
                yardstick="stacked per-kernel path (K1 GEMV, K2 with slopes), same step, "
                          "device time (profiler)"))
            log_case(cases_out[-1])

        layer = 5
        for length in (0, 1000, 4000):
            h = (torch.randn((1, h_dim), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
            step = (h, *args, cache, layer, length, nq, nq, cfg.rms_eps)
            got = mk.w4a16_llama_layer_step(*step, shape="mpt")
            ref = mk.w4a16_llama_layer_step_plain(*step, shape="mpt")
            torch.cuda.synchronize()
            ms = timer(lambda: mk.w4a16_llama_layer_step(*step, shape="mpt"))
            plain_ms = timer(lambda: mk.w4a16_llama_layer_step_plain(*step, shape="mpt"), reps=3)
            yard = device_ms(torch, lambda: llama.stacked_layers(params, cfg, h[None], cache,
                                                                 length, layer_ids=[layer]))
            record("megakernel_layer_mpt" + sfx, f"layer {layer} len={length}", got, ref,
                   tol_layer, ms, plain_ms, yard, layer_bytes + kv_pos * (length + 1),
                   layer_flops + 4.0 * nq * hd * (length + 1))
        length, bucket = 1000, 2047
        pos = torch.tensor([length], dtype=torch.int32, device="cuda")
        h = (torch.randn((1, h_dim), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        step_host = (h, *args, cache, length, nq, nq, cfg.rms_eps)
        step = (h, *args, cache, pos, nq, nq, cfg.rms_eps)
        got = mk.w4a16_llama_token_step(*step, max_length=bucket, **head)
        ref = mk.w4a16_llama_token_step_plain(*step_host, **head)
        host = mk.w4a16_llama_token_step(*step_host, **head)
        torch.cuda.synchronize()
        k4_same("megakernel_token_mpt" + sfx, got, host)
        ms = timer(lambda: mk.w4a16_llama_token_step(*step, max_length=bucket, **head))
        host_ms = timer(lambda: mk.w4a16_llama_token_step(*step_host, **head))
        log(f"  megakernel_token_mpt{sfx} len={length}: {ms:.4f} ms with its position in device "
            f"memory (bucket {bucket + 1}), {host_ms:.4f} ms given it as a host int")
        plain_ms = timer(lambda: mk.w4a16_llama_token_step_plain(*step_host, **head), reps=2)

        def stacked_token():
            hh = llama.stacked_layers(params, cfg, h[None], cache, length)
            return llama._head_logits(params, llama._norm(cfg, hh, params["norm"]), "auto")

        yard = device_ms(torch, stacked_token)
        record("megakernel_token_mpt" + sfx,
               f"{L} layers + {wname} head, len={length} (device position, bucket "
               f"{bucket + 1})", got, ref, tol_deep, ms, plain_ms, yard,
               L * (layer_bytes + kv_pos * (length + 1)) + qlinear_bytes(params["lm_head"]),
               L * (layer_flops + 4.0 * nq * hd * (length + 1)) + 2.0 * h_dim * vocab)
        del params, la, lins, args, cache, step, step_host, head, got, ref, host
        torch.cuda.empty_cache()


def scatter_pages(torch, cache, mp, page, gen, need=None):
    """A slot cache ``[L, 2, B, nkv, mp*page, hd]`` scattered into a pool of
    permuted pages: ``(pool [L, 2, NP, nkv, page, hd], tables [B, mp] int32)``.
    Row b gets ``need[b]`` pages (all ``mp`` by default); its other table
    entries are 0, the trash page, which holds random data."""
    L, _, b, nkv, _, hd = cache.shape
    need = [mp] * b if need is None else need
    n_pages = 1 + sum(need)
    perm = (torch.randperm(n_pages - 1, generator=gen, device=gen.device) + 1).tolist()
    tables = torch.zeros((b, mp), dtype=torch.int32)
    pool = torch.randn((L, 2, 1, nkv, page, hd), generator=gen, device=cache.device
                       ).to(cache.dtype).expand(L, 2, n_pages, nkv, page, hd).contiguous()
    for i in range(b):
        for j in range(need[i]):
            pid = perm.pop()
            tables[i, j] = pid
            pool[:, :, pid] = cache[:, :, i, :, j * page:(j + 1) * page]
    return pool, tables.to(cache.device)


def plan_of(entry, m, ic, oc, g=128, dtype=None):
    """The host plan of a K1 case (the GEMV's tiles, splits and slots; the
    wgmma GEMMs' orientation and split count) or of a K11 case, for the case
    line."""
    import torch

    from awq_tpu_torch.ops import w4a16 as w4

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    if entry in ("w4a16_gemv", "w3a16_gemv"):
        p = w4.gemv_plan(m, ic, oc, g, entry[:5], n_sm, dtype or torch.bfloat16)
        return {"plan": f"{p.tiles} tiles x {p.splits} split{'s' if p.splits > 1 else ''} "
                        f"(cluster), {p.stages} slots, {'tensor cores' if p.tc else 'f32'}, "
                        f"{p.smem} B shared"}
    kind = {"w4a16_gemm": "w4a16", "w3a16_gemm": "w3a16", "w8a8_gemm": "w8a8"}.get(entry)
    if kind is None:
        return {}
    p = w4.gemm_plan(m, ic, oc, kind, n_sm)
    orient = f"weights as A, tokens as N={p.tile_m}" if p.swap else "128x128 tiles"
    return {"plan": f"{orient}, {p.splits} split{'s' if p.splits > 1 else ''}, "
                    f"{p.blocks} blocks"}


def decode_plan_of(name, b, nq, nkv, hd, max_length, esize, page=0, by_length=False):
    """The host plan of a split flash-decode case (K2, K8, K9, K14), as its
    wrapper makes it: cluster, positions a block, stages, for the case line
    (``by_length``: the grid of a launch that splits by the length it reads,
    planned for the bound ``max_length``)."""
    import torch

    from awq_tpu_torch.ops import decode_attn as da

    p = da.decode_plan(b, nq, nkv, hd, max_length, esize, da.PLAN_UNIT[name], page,
                       sms=torch.cuda.get_device_properties(0).multi_processor_count,
                       cur=name != "flash_decode_layer", by_length=by_length)
    return {"plan": p.describe() + (", split by the length read" if by_length else "")}


def log_case(c):
    lib = ("library_ms=none" if c["library_ms"] is None
           else f"library_ms={c['library_ms']:.4f}")
    if "yardstick_ms" in c:
        lib += f" yardstick_ms={c['yardstick_ms']:.4f} ({c['yardstick']})"
    plan = f" [{c['plan']}]" if "plan" in c else ""
    log(f"  {c['name']:16s} {c['shape']:34s} max_abs_err={c['max_abs_err']:.3e} "
        f"max_rel_err={c['max_rel_err']:.3e} (tol {c['tol']}) "
        f"kernel_ms={c['ms']:.4f} plain_ms="
        + ("none" if c["plain_ms"] is None else f"{c['plain_ms']:.4f}") + " "
        f"{lib} bound_ms={c['bound_ms']:.4f} ({c['bound_by']}){plan}")


def device_ms(torch, fn, reps: int = 2) -> float:
    """Device time of one call: the sum of its kernels' durations in a
    torch.profiler trace, over ``reps`` calls after a warm one, no L2 flush.
    For the stacked path, whose ~1700 launches per token overflow the
    launch queue while the host enqueues them, so that CUDA events around
    it would time the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / reps / 1e3


def qlinear_bytes(ql, layer=None) -> int:
    """Bytes of one layer of a stacked QLinear (or all of a 2-D one)."""
    ts = [ql.qweight, ql.scales, ql.szeros] + ([ql.bias] if ql.bias is not None else [])
    n = sum(t.numel() * t.element_size() for t in ts)
    return n // ql.qweight.shape[0] if layer is not None else n


def phase_megakernels(torch, timer, cases_out, w3=False):
    """Phase 2, continued: K4 (layer and token entries), K5 and K6 (slot,
    int8 and paged modes) against their plain versions at Llama-3-8B width;
    the yardstick is the stacked per-kernel path's device time for the same
    step. ``w3``: the same over a W3 model (pack_int3 linears and head), the
    kernels' W3 modes, named with a ``_w3`` suffix; K4's int8 mode is
    held over W4 only."""
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama
    from awq_tpu_torch.ops import megakernel as mk
    from awq_tpu_torch.ops import megakernel_chunk as mkc
    from awq_tpu_torch.ops.w4a16 import QLinear

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(4321)
    cfg = ModelConfig(**LLAMA3_8B)
    h_dim, nq, nkv, hd, L = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim, cfg.num_layers)
    w_bit, sfx, wname = (3, "_w3", "W3") if w3 else (4, "", "W4")
    params = llama.fuse_linears(llama.init_qparams(
        cfg, QuantConfig(w_bit=w_bit, group_size=G), gen), cfg)
    vocab = cfg.vocab_size
    s_head = (torch.rand((h_dim // G, vocab), generator=gen, device=dev) + 0.5) * 0.005
    params["lm_head"] = QLinear(
        qweight=torch.randint(-(2**31), 2**31 - 1,
                              (h_dim * 3 // 32 if w3 else h_dim // 8, vocab), generator=gen,
                              dtype=torch.int32, device=dev),
        scales=s_head, szeros=s_head * 2 ** (w_bit - 1), w_bit=w_bit, dense3=w3)
    la = params["layers"]
    lins = (la["wqkv"], la["wo"], la["wgateup"], la["down"])
    args = lins + (la["ln1"], la["ln2"])
    t_cache = 4096 + 64
    cache = llama.init_kv_cache(cfg, 1, t_cache)
    cache.normal_(generator=gen)
    cos, sin = llama.rope_table(cfg, t_cache, device=dev)
    eps = cfg.rms_eps
    layer_bytes = sum(qlinear_bytes(p, 0) for p in lins) + 2 * h_dim * 2
    layer_flops = 2 * sum(p.in_features * p.out_features for p in lins)
    head_bytes = qlinear_bytes(params["lm_head"])
    kv_pos = 2 * nkv * hd * 2                    # bytes per layer and position
    # One layer: bf16 output, f32 sums in other orders than the plain
    # version; 2^-6 of the largest value, as for K1. Over all 32 layers of a
    # random model each layer's bf16 rounding of the residual can land on
    # the other side and carry on: 5e-2, as for the model-level check.
    tol_layer, tol_deep = 2.0 ** -6, 5e-2

    def record(name, shape, got, ref, tol, ms, plain_ms, yard_ms, nbytes, flops,
               yard="stacked per-kernel path, same step, device time (profiler)"):
        name, shape = name + sfx, shape.replace("W4 head", f"{wname} head")
        err = rel = 0.0
        for i, (g, r) in enumerate(zip(got, ref)):
            e, r_ = check(f"{name} {shape} output {i}", g, r, tol)
            err, rel = max(err, e), max(rel, r_)
        b_ms, b_by = bound(nbytes, flops)
        cases_out.append(dict(
            name=name, shape=shape, max_abs_err=err, max_rel_err=rel,
            tol=f"{tol:g}*max|ref|", ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, library="none",
            yardstick_ms=yard_ms, yardstick=yard))
        log_case(cases_out[-1])

    layer, layer_ms = 5, {}
    for length in (0, 1000, 4000):
        h = (torch.randn((1, h_dim), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        step = (h, *args, cos[length], sin[length], cache, layer, length, nq, nkv, eps)
        got = mk.w4a16_llama_layer_step(*step)
        ref = mk.w4a16_llama_layer_step_plain(*step)
        torch.cuda.synchronize()
        ms = layer_ms[length] = timer(lambda: mk.w4a16_llama_layer_step(*step))
        plain_ms = timer(lambda: mk.w4a16_llama_layer_step_plain(*step), reps=3)
        yard_ms = device_ms(torch, lambda: llama.stacked_layers(params, cfg, h[None], cache, length,
                                                    layer_ids=[layer]))
        record("megakernel_layer", f"layer {layer} len={length}", got, ref, tol_layer,
               ms, plain_ms, yard_ms, layer_bytes + kv_pos * (length + 1),
               layer_flops + 4.0 * nq * hd * (length + 1))

    # the token entry as the served decode step launches it: the position
    # in device memory, the rope rows gathered from the tables, the
    # workspace sized for the burst's bucket (served requests at length 1000
    # take the 2048-position one); held to the plain version and, bit for
    # bit, to the launch given the length as a host int
    length, bucket = 1000, 2047
    pos = torch.tensor([length], dtype=torch.int32, device=dev)
    h = (torch.randn((1, h_dim), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    step_host = (h, *args, cos[length], sin[length], cache, length, nq, nkv, eps)
    step = (h, *args, cos, sin, cache, pos, nq, nkv, eps)
    head = dict(whead=params["lm_head"], norm_w=params["norm"])
    got = mk.w4a16_llama_token_step(*step, max_length=bucket, **head)
    ref = mk.w4a16_llama_token_step_plain(*step_host, **head)
    host = mk.w4a16_llama_token_step(*step_host, **head)
    torch.cuda.synchronize()
    k4_same("megakernel_token" + sfx, got, host)
    ms = timer(lambda: mk.w4a16_llama_token_step(*step, max_length=bucket, **head))
    host_len_ms = timer(lambda: mk.w4a16_llama_token_step(*step_host, **head))
    log(f"  megakernel_token{sfx} len={length}: {ms:.4f} ms with its position in device "
        f"memory (bucket {bucket + 1}), {host_len_ms:.4f} ms given it as a host int")
    plain_ms = timer(lambda: mk.w4a16_llama_token_step_plain(*step_host, **head), reps=2)

    def stacked_token():
        hh = llama.stacked_layers(params, cfg, h[None], cache, length)
        return llama._head_logits(params, llama.rms_norm(hh, params["norm"], eps), "auto")

    yard_ms = device_ms(torch, stacked_token)
    token_flops = L * (layer_flops + 4.0 * nq * hd * (length + 1)) + 2.0 * h_dim * vocab
    record("megakernel_token", f"{L} layers + W4 head, len={length} (device position, "
           f"bucket {bucket + 1})", got, ref, tol_deep, ms, plain_ms, yard_ms,
           L * (layer_bytes + kv_pos * (length + 1)) + head_bytes, token_flops)

    # K4's int8 mode (cache_scales) over the same cache quantized: the token
    # entry (yardstick: the bf16 K4 token step above) and the layer entry
    # (yardstick: the bf16 layer step at the same length); the in-place
    # write is held as check_int8_write says
    kv8_pos = 2 * nkv * (hd + 4)              # int8 codes + f32 scale, per layer
    if not w3:
        codes, scales = quantize_cache(torch, cache)
        c8 = [(codes, scales), (codes.clone(), scales.clone())]
        one = torch.zeros(1, dtype=torch.long, device=dev)
        at = torch.full((1,), length, dtype=torch.long, device=dev)
        bf16_token_ms = ms
        c8.append(tuple(x.clone() for x in c8[0]))
        got = mk.w4a16_llama_token_step(*step[:9], c8[0][0], pos, nq, nkv, eps,
                                        cache_scales=c8[0][1], max_length=bucket, **head)
        ref = mk.w4a16_llama_token_step_plain(*step_host[:9], c8[1][0], length, nq, nkv, eps,
                                              cache_scales=c8[1][1], **head)
        host = mk.w4a16_llama_token_step(*step_host[:9], c8[2][0], length, nq, nkv, eps,
                                         cache_scales=c8[2][1], **head)
        torch.cuda.synchronize()
        check_int8_write(torch, "megakernel_token_int8", c8[0], c8[1],
                         [x[:, None] for x in got[1:3]], one, at, tol_deep)
        k4_same("megakernel_token_int8", got, host)
        if not all(torch.equal(x, y) for x, y in zip(c8[0], c8[2])):
            raise AssertionError("megakernel_token_int8: the device-position launch wrote "
                                 "other codes or scales than the host-length launch")
        c8.pop()
        ms = timer(lambda: mk.w4a16_llama_token_step(*step[:9], c8[0][0], pos, nq, nkv, eps,
                                                     cache_scales=c8[0][1], max_length=bucket,
                                                     **head))
        plain_ms = timer(lambda: mk.w4a16_llama_token_step_plain(
            *step_host[:9], c8[1][0], length, nq, nkv, eps, cache_scales=c8[1][1], **head),
            reps=2)
        record("megakernel_token_int8", f"{L} layers + W4 head, len={length} (device "
               f"position, bucket {bucket + 1})", got, ref,
               tol_deep, ms, plain_ms, bf16_token_ms,
               L * (layer_bytes + kv8_pos * (length + 1)) + head_bytes, token_flops,
               yard="K4 over the bf16 cache, same step")
        for x, y in zip(*c8):     # the token step wrote both: start the layer entry equal
            x.copy_(y)
        got = mk.w4a16_llama_layer_step(*step_host[:9], c8[0][0], layer, length, nq, nkv, eps,
                                        cache_scales=c8[0][1])
        ref = mk.w4a16_llama_layer_step_plain(*step_host[:9], c8[1][0], layer, length, nq, nkv,
                                              eps, cache_scales=c8[1][1])
        torch.cuda.synchronize()
        pick = torch.arange(L, device=dev) == layer         # only layer `layer` is written
        check_int8_write(torch, "megakernel_layer_int8",
                         tuple(x[pick] for x in c8[0]), tuple(x[pick] for x in c8[1]),
                         [x[:, None] for x in got[1:3]], one, at, tol_layer)
        for x, y in zip(c8[0], c8[1]):
            if not torch.equal(x[~pick], y[~pick]):
                raise AssertionError("megakernel_layer_int8: the kernel wrote another layer")
        ms = timer(lambda: mk.w4a16_llama_layer_step(*step_host[:9], c8[0][0], layer, length,
                                                     nq, nkv, eps, cache_scales=c8[0][1]))
        plain_ms = timer(lambda: mk.w4a16_llama_layer_step_plain(
            *step_host[:9], c8[1][0], layer, length, nq, nkv, eps, cache_scales=c8[1][1]),
            reps=3)
        record("megakernel_layer_int8", f"layer {layer} len={length}", got, ref, tol_layer, ms,
               plain_ms, layer_ms[length], layer_bytes + kv8_pos * (length + 1),
               layer_flops + 4.0 * nq * hd * (length + 1),
               yard="K4 layer entry over the bf16 cache, same length")
        del codes, scales, c8

    # K5: windows of 16 and 32 rows at hist 0 and 700 over the bf16 cache
    # (the f32 and f16 units below), each held to its plain version as a
    # whole and row by row, its yardstick the stacked path's device time
    # for the same window; two calls at the last shape give the same bits
    if not w3:
        log_cluster_probe(torch)
    for s in (16, 32):
        log_k5_plan(torch, cfg, s, w3)
    for s in (16, 32):
        for hist in (0, 700):
            hw = (torch.randn((s, h_dim), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
            step = (hw, *args, cos[hist:hist + s], sin[hist:hist + s], cache, hist,
                    nq, nkv, eps)
            got = mkc.w4a16_llama_chunk_step(*step)
            ref = mkc.w4a16_llama_chunk_step_plain(*step)
            torch.cuda.synchronize()
            check_chunk_rows(torch, f"megakernel_chunk{sfx} S={s} hist={hist}", got, ref,
                             tol_deep)
            ms = timer(lambda: mkc.w4a16_llama_chunk_step(*step))
            plain_ms = timer(lambda: mkc.w4a16_llama_chunk_step_plain(*step), reps=2)
            yard_ms = device_ms(torch, lambda: llama.stacked_layers(params, cfg, hw[None], cache, hist))
            pairs = s * hist + s * (s + 1) // 2
            record("megakernel_chunk", f"{L} layers S={s} hist={hist}", got, ref, tol_deep,
                   ms, plain_ms, yard_ms, L * (layer_bytes + kv_pos * (hist + s)),
                   L * (s * layer_flops + 4.0 * nq * hd * pairs))
    check_chunk_twice(torch, f"megakernel_chunk{sfx}_bf16", mkc, step)
    # the f32 and f16 caches' units on windows of their own (a generator of
    # their own, so that the cases after them keep their data); K6's cases
    # below are drawn once more from the stream as it runs on from here
    # when these windows come from ``gen`` (check_k6_other_stream)
    k5_state = gen.get_state()
    gen_t = torch.Generator(device=dev).manual_seed(8765)
    for dt, tag in ((torch.float32, "f32"), (torch.float16, "f16")):
        cache_t = cache.to(dt)
        for s in (16, 32):
            for hist in (0, 700):
                hw = (torch.randn((s, h_dim), generator=gen_t, device=dev) * 0.5).to(torch.bfloat16)
                step = (hw, *args, cos[hist:hist + s], sin[hist:hist + s], cache_t, hist,
                        nq, nkv, eps)
                got = mkc.w4a16_llama_chunk_step(*step)
                ref = mkc.w4a16_llama_chunk_step_plain(*step)
                torch.cuda.synchronize()
                name = f"megakernel_chunk{sfx}_{tag} S={s} hist={hist}"
                err = max(check(f"{name} output {i}", g, r, tol_deep)[1]
                          for i, (g, r) in enumerate(zip(got, ref)))
                check_chunk_rows(torch, name, got, ref, tol_deep)
                ms = timer(lambda: mkc.w4a16_llama_chunk_step(*step))
                log(f"  {name}: {ms:.4f} ms, rel to the plain version {err:.2e}")
        check_chunk_twice(torch, f"megakernel_chunk{sfx}_{tag}", mkc, step)
        del cache_t
    del cache

    # K6: the continuous-batching step, 8 and 32 rows at ragged lengths
    # around 1000 (row 1 is empty); the yardstick is the stacked batched
    # path (K1 at M rows, K2 with its append, glue) for the same step
    from awq_tpu_torch.ops import megakernel_batched as mkb

    t_b = 2048
    cos, sin = llama.rope_table(cfg, t_b, device=dev)
    for b in (8, 32):
        ragged = [700 + (i * 97) % 600 for i in range(b)]
        ragged[1] = 0
        mx, total = max(ragged), sum(ragged) + b
        lens = torch.tensor(ragged, dtype=torch.int32, device=dev)
        cache_b = llama.init_kv_cache(cfg, b, t_b)
        cache_b.normal_(generator=gen)
        # the same rows paged (for K6's paged mode below): each row's pages
        # up to its write position, scattered over a permuted pool
        pool, tables = scatter_pages(torch, cache_b, t_b // 256, 256, gen,
                                     need=[n // 256 + 1 for n in ragged])
        cache_ref = cache_b.clone()             # the plain version's own cache
        h = (torch.randn((b, h_dim), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        rope = (cos[lens.long()], sin[lens.long()])
        step = (h, *args, *rope, cache_b, lens, nq, nkv, eps)
        step_ref = (h, *args, *rope, cache_ref, lens, nq, nkv, eps)
        kw = dict(whead=params["lm_head"], norm_w=params["norm"], max_length=mx)
        got = mkb.w4a16_llama_token_step_batched(*step, **kw)
        ref = mkb.w4a16_llama_token_step_batched_plain(*step_ref, **kw)
        torch.cuda.synchronize()
        # the in-place write over all layers: each row's k/v sit at its own
        # length, as returned, within tolerance of the plain cache's, and
        # every other element of the two caches is equal bit for bit
        rows, at = torch.arange(b, device=dev), lens.long()
        for i in (0, 1):
            if not torch.equal(cache_b[:, i, rows, :, at].transpose(0, 1), got[1 + i]):
                raise AssertionError(f"megakernel_batched B={b}: the cache does not hold "
                                     "the returned k/v at each row's length")
            check(f"megakernel_batched B={b} cache written, kv {i}",
                  cache_b[:, i, rows, :, at], cache_ref[:, i, rows, :, at], tol_deep)
        written = cache_ref[:, :, rows, :, at]
        cache_ref[:, :, rows, :, at] = cache_b[:, :, rows, :, at]
        if not torch.equal(cache_b, cache_ref):
            raise AssertionError(f"megakernel_batched B={b}: the kernel changed the cache "
                                 "outside the rows' write positions")
        cache_ref[:, :, rows, :, at] = written
        del written
        ms = timer(lambda: mkb.w4a16_llama_token_step_batched(*step, **kw))
        plain_ms = timer(lambda: mkb.w4a16_llama_token_step_batched_plain(*step_ref, **kw),
                         reps=2)
        # K6 sums in a fixed order: a call after the timed ones (same inputs,
        # the same k/v written at the same positions) gives the same bits
        again = mkb.w4a16_llama_token_step_batched(*step, **kw)
        if not all(torch.equal(x, y) for x, y in zip(again, got)):
            raise AssertionError(f"megakernel_batched{sfx} B={b}: two calls differ")
        del again
        log(f"  megakernel_batched{sfx} B={b}: two calls bit-equal (outputs, logits, k/v)")
        log(f"  megakernel_batched{sfx} B={b}: host enqueue "
            f"{host_ms(torch, lambda: mkb.w4a16_llama_token_step_batched(*step, **kw)):.4f} ms "
            "a step (median of 20 calls: the wrapper, its plan and the launch, the device "
            "drained before each)")
        log_k6_plan(torch, cfg, b, w3)

        def stacked_step():
            hh = llama.stacked_layers(params, cfg, h[:, None], cache_b, 0,
                                      lengths=lens, max_length=mx)[:, 0]
            return llama._head_logits(params, llama.rms_norm(hh, params["norm"], eps), "auto")

        yard_ms = device_ms(torch, stacked_step)
        k6_bytes = L * (layer_bytes + kv_pos * total) + head_bytes + 2 * b * h_dim * 2
        k6_flops = b * (L * layer_flops + 2.0 * h_dim * vocab) + L * 4.0 * nq * hd * total
        record("megakernel_batched", f"{L} layers + W4 head, B={b}, len 0..{mx}", got, ref,
               tol_deep, ms, plain_ms, yard_ms, k6_bytes, k6_flops)

        # K6's int8 slot mode on the same rows over the cache quantized; the
        # yardstick is the bf16 K6 on these rows (just above)
        c8 = quantize_cache(torch, cache_b)
        del cache_b, cache_ref, step, step_ref, ref
        torch.cuda.empty_cache()
        c8 = [c8, tuple(x.clone() for x in c8)]
        got8 = mkb.w4a16_llama_token_step_batched(h, *args, *rope, c8[0][0], lens, nq, nkv, eps,
                                                  cache_scales=c8[0][1], **kw)
        ref8 = mkb.w4a16_llama_token_step_batched_plain(h, *args, *rope, c8[1][0], lens, nq,
                                                        nkv, eps, cache_scales=c8[1][1], **kw)
        torch.cuda.synchronize()
        check_int8_write(torch, f"megakernel_batched_int8 B={b}", c8[0], c8[1], got8[1:3],
                         rows, at, tol_deep)
        ms8 = timer(lambda: mkb.w4a16_llama_token_step_batched(
            h, *args, *rope, c8[0][0], lens, nq, nkv, eps, cache_scales=c8[0][1], **kw))
        plain_ms = timer(lambda: mkb.w4a16_llama_token_step_batched_plain(
            h, *args, *rope, c8[1][0], lens, nq, nkv, eps, cache_scales=c8[1][1], **kw), reps=2)
        record("megakernel_batched_int8", f"{L} layers + W4 head, B={b}, len 0..{mx}", got8,
               ref8, tol_deep, ms8, plain_ms, ms,
               L * (layer_bytes + 2 * nkv * (hd + 4) * total) + head_bytes + 2 * b * h_dim * 2,
               k6_flops, yard="bf16 K6, same rows")
        del c8, got8, ref8
        torch.cuda.empty_cache()

        # K6's paged mode on the same rows; the yardstick is the contiguous K6
        pool_ref = pool.clone()
        kw_p = dict(kw, tables=tables)
        step = (h, *args, *rope, pool, lens, nq, nkv, eps)
        step_ref = (h, *args, *rope, pool_ref, lens, nq, nkv, eps)
        got_p = mkb.w4a16_llama_token_step_batched(*step, **kw_p)
        ref = mkb.w4a16_llama_token_step_batched_plain(*step_ref, **kw_p)
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got_p, got))
        if not same:
            raise AssertionError(f"megakernel_batched_paged{sfx} B={b}: outputs differ from "
                                 "the slot mode's on the same rows")
        where = tables.long()[rows, at // 256]
        off = at % 256
        for i in (0, 1):
            if not torch.equal(pool[:, i, where, :, off].transpose(0, 1), got_p[1 + i]):
                raise AssertionError(f"megakernel_batched_paged B={b}: the pool does not "
                                     "hold the returned k/v at each row's page and offset")
            check(f"megakernel_batched_paged B={b} pool written, kv {i}",
                  pool[:, i, where, :, off], pool_ref[:, i, where, :, off], tol_deep)
        pool_ref[:, :, where, :, off] = pool[:, :, where, :, off]
        if not torch.equal(pool, pool_ref):
            raise AssertionError(f"megakernel_batched_paged B={b}: the kernel changed the "
                                 "pool outside the rows' write positions")
        ms_p = timer(lambda: mkb.w4a16_llama_token_step_batched(*step, **kw_p))
        plain_ms = timer(lambda: mkb.w4a16_llama_token_step_batched_plain(*step_ref, **kw_p),
                         reps=2)
        record("megakernel_batched_paged",
               f"{L} layers + W4 head, B={b}, len 0..{mx}, page 256", got_p, ref, tol_deep,
               ms_p, plain_ms, ms, k6_bytes + b * (t_b // 256) * 4, k6_flops,
               yard=f"contiguous K6, same rows (outputs {'equal' if same else 'differ'})")
        del pool, pool_ref, step, step_ref, got, got_p, ref
        torch.cuda.empty_cache()
    if not w3:
        check_k6_other_stream(torch, cfg, params, k5_state, t_b, tol_deep)
    del params


def k4_same(name, got, host):
    """K4's launch with its position in device memory against the launch
    given the same length as a host int: every output bit-equal."""
    if not all(x.dtype == y.dtype and bool((x == y).all()) for x, y in zip(got, host)):
        raise AssertionError(f"{name}: the device-position launch differs from the "
                             "host-length launch")
    log(f"  {name}: the device-position launch is bit-equal to the host-length launch "
        "(outputs, k/v, logits)")


def check_k6_other_stream(torch, cfg, params, state, t_b, tol):
    """K6's 32-row int8 case on the data it drew when K5's f32/f16 windows
    shared K6's generator: the random stream from ``state`` (taken where
    those windows are drawn) runs through the windows' draws and the draws
    of the 8-row and 32-row K6 cases in order, and the 32-row int8 case is
    checked as above (its written cache within ``tol`` of the plain
    version's, the rest of the cache bit-equal). This window failed the
    written-cache check with K6's W4 codes biased by 2^7."""
    from awq_tpu_torch.models import llama
    from awq_tpu_torch.ops import megakernel_batched as mkb

    dev = "cuda"
    g = torch.Generator(device=dev)
    g.set_state(state)
    h_dim, nq, nkv, hd, L = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim, cfg.num_layers)
    for _ in range(2):                     # the f32 and f16 caches' windows
        for s in (16, 32):
            for _ in (0, 700):
                torch.randn((s, h_dim), generator=g, device=dev)
    cos, sin = llama.rope_table(cfg, t_b, device=dev)
    for b in (8, 32):
        ragged = [700 + (i * 97) % 600 for i in range(b)]
        ragged[1] = 0
        cache_b = llama.init_kv_cache(cfg, b, t_b)
        cache_b.normal_(generator=g)
        n_pages = 1 + sum(n // 256 + 1 for n in ragged)   # scatter_pages' draws
        torch.randperm(n_pages - 1, generator=g, device=dev)
        torch.randn((L, 2, 1, nkv, 256, hd), generator=g, device=dev)
        h = (torch.randn((b, h_dim), generator=g, device=dev) * 0.5).to(torch.bfloat16)
        if b == 8:
            del cache_b
            continue
        lens = torch.tensor(ragged, dtype=torch.int32, device=dev)
        c8 = quantize_cache(torch, cache_b)
        del cache_b
        torch.cuda.empty_cache()
        c8 = [c8, tuple(x.clone() for x in c8)]
        la = params["layers"]
        args8 = (la["wqkv"], la["wo"], la["wgateup"], la["down"], la["ln1"], la["ln2"],
                 cos[lens.long()], sin[lens.long()])
        kw = dict(whead=params["lm_head"], norm_w=params["norm"], max_length=max(ragged))
        got8 = mkb.w4a16_llama_token_step_batched(h, *args8, c8[0][0], lens, nq, nkv,
                                                  cfg.rms_eps, cache_scales=c8[0][1], **kw)
        ref8 = mkb.w4a16_llama_token_step_batched_plain(h, *args8, c8[1][0], lens, nq, nkv,
                                                        cfg.rms_eps, cache_scales=c8[1][1],
                                                        **kw)
        torch.cuda.synchronize()
        name = "megakernel_batched_int8 B=32 (K5's f32/f16 windows on K6's stream)"
        rows, at = torch.arange(b, device=dev), lens.long()
        check_int8_write(torch, name, c8[0], c8[1], got8[1:3], rows, at, tol)
        for i, (x, r) in enumerate(zip(got8, ref8)):
            check(f"{name} output {i}", x, r, tol)
        log(f"  {name}: the written cache and the outputs hold")
        del c8, got8, ref8
        torch.cuda.empty_cache()


def host_ms(torch, fn, reps: int = 20) -> float:
    """Median host time of one call of ``fn`` (no sync inside), the device
    drained before each call."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def log_k6_plan(torch, cfg, b, w3):
    """One line of K6's schedule for ``b`` rows (``batched_plan``): the
    grid and blocks an SM, the ring, the windows over IC and each matmul
    phase's wave, warps a tile and windows, and the unit's registers and
    spills as ptxas printed them."""
    from awq_tpu_torch import _build
    from awq_tpu_torch.ops import megakernel_batched as mkb

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = mkb.batched_plan(b, cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
                         cfg.num_kv_heads, cfg.vocab_size, w3, sms)
    unit = "megakernel_batched_bf16" + ("_w3" if w3 else "")
    regs = " ".join(ln.split("info    :")[-1].strip() for ln in _build.build_log(unit).splitlines()
                    if "registers" in ln or "spill" in ln)
    phases = "; ".join(f"{n} wave {v['wave']} k {v['k']} windows {v['windows']}"
                       for n, v in p["phases"].items())
    log(f"  K6 plan B={b}{' W3' if w3 else ''}: grid {p['grid']} ({p['grid'] // sms} block an SM, "
        f"{p['threads']} threads), {p['smem']} B shared, ring {p['slots']} slots of "
        f"{p['stage_bytes']} B, windows of {p['window']} chunks of {p['chunk']} channels; "
        f"{phases}; {unit}: {regs}")


def log_k5_plan(torch, cfg, s, w3):
    """One line of K5's schedule for a window of ``s`` rows (``batched_plan``
    in its chunk mode): the grid in clusters, the shared memory, the ring,
    the windows over a rank's IC and each matmul phase's wave, warps a tile
    and windows, and the unit's registers and spills as ptxas printed them."""
    from awq_tpu_torch import _build
    from awq_tpu_torch.ops import megakernel_batched as mkb
    from awq_tpu_torch.ops import megakernel_chunk as mkc

    unit = "megakernel_chunk_bf16" + ("_w3" if w3 else "")
    grid = mkc._card_grid(torch.cuda.current_device(), unit, mkc.CLUSTER)
    p = mkb.batched_plan(s, cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
                         cfg.num_kv_heads, 0, w3, grid, cluster=mkc.CLUSTER)
    regs = " ".join(ln.split("info    :")[-1].strip() for ln in _build.build_log(unit).splitlines()
                    if "registers" in ln or "spill" in ln)
    phases = "; ".join(f"{n} wave {v['wave']} k {v['k']} windows {v['windows']}"
                       for n, v in p["phases"].items())
    log(f"  K5 plan S={s}{' W3' if w3 else ''}: grid {p['grid']} in clusters of {p['cluster']} "
        f"(each rank 1/{p['cluster']} of IC), {p['threads']} threads, {p['smem']} B shared, "
        f"ring {p['slots']} slots of {p['stage_bytes']} B, windows of {p['window']} chunks of "
        f"{p['chunk']} channels; {phases}; {unit}: {regs}")


def log_cluster_probe(torch):
    """The cluster probe: the grid a cooperative launch of K5's block (288
    threads, 227 KB) gets on this card in clusters of 1, 2, 4 and 8 blocks
    (``cudaOccupancyMaxActiveClusters``); K5 launches clusters of
    ``megakernel_chunk.CLUSTER`` with the cooperative attribute and
    ``grid.sync()``s, which its checks below prove."""
    import ctypes

    from awq_tpu_torch import _build

    lib = _build.load("megakernel_chunk_bf16")
    fn = lib.awq_mega_chunk_grid
    _build.declare(fn, _build.I, _build.P)
    got = []
    for cl in (1, 2, 4, 8):
        g = ctypes.c_int(0)
        err = fn(cl, ctypes.byref(g))
        got.append(f"{cl}: {g.value} blocks" if err == 0 else f"{cl}: CUDA error {err}")
    log("  cluster probe (a cooperative launch with a cluster dimension, K5's block): grid in "
        "clusters of " + ", ".join(got))


def check_chunk_rows(torch, name, got, ref, tol):
    """K5's per-row check: each window row of h and each (layer, kv head,
    row) of the k/v written within ``tol`` of its own largest magnitude
    against the plain version, so that a fault in one row cannot hide
    under another row's larger values."""
    for what, g, r in (("h", got[0], ref[0]), ("k", got[1].flatten(0, 2), ref[1].flatten(0, 2)),
                       ("v", got[2].flatten(0, 2), ref[2].flatten(0, 2))):
        g, r = g.float().flatten(1), r.float().flatten(1)
        err, scale = (g - r).abs().amax(1), r.abs().amax(1)
        bad = torch.nonzero(err > tol * scale).flatten().tolist()
        if bad:
            raise AssertionError(f"{name}: {what} rows {bad[:8]} off by "
                                 f"{(err / scale)[bad[:8]].tolist()} of their own largest value")
    log(f"  {name}: every window row of h and k/v within {tol:g} of its own largest value")


def check_chunk_twice(torch, name, mkc, step):
    """K5 sums in a fixed order: two calls on equal copies of the cache give
    the same outputs and the same cache, bit for bit."""
    outs = []
    for _ in range(2):
        c = step[9].clone()
        got = mkc.w4a16_llama_chunk_step(*step[:9], c, *step[10:])
        torch.cuda.synchronize()
        outs.append((*got, c))
    if not all(torch.equal(x, y) for x, y in zip(*outs)):
        raise AssertionError(f"{name}: two calls differ")
    log(f"  {name}: two calls bit-equal (outputs, k/v and the cache written)")


def weight_bytes(params) -> int:
    from awq_tpu_torch.ops.w4a16 import QLinear

    total = 0
    for p in list(params["layers"].values()) + [params.get("lm_head")]:
        if isinstance(p, QLinear):
            total += sum(t.numel() * t.element_size()
                         for t in (p.qweight, p.scales, p.szeros, p.bias)
                         if t is not None)
    return total


REQUESTS = ((16, True), (200, False), (1000, True), (24, False))   # (prompt, fresh)
# label: (AWQ_TPU_DISABLE_MEGAKERNEL, kernels that must run, kernels that must
# not) for phases 3 and 3d (single stream)
SERVE_PATHS = {
    "megakernels": (None, ("megakernel_token", "megakernel_chunk"),
                    ("megakernel_token_int8", "flash_decode_int8")),
    "stacked": ("1", ("w4a16_gemv", "w4a16_gemm", "flash_decode", "flash_prefill"),
                ("megakernel_token", "megakernel_chunk")),
    # the int8 cache: K5 takes none (as in JAX), so every prompt takes the
    # stacked prefill (K1 GEMM, K3 over the dequantized prefix)
    "megakernels_int8": (None, ("megakernel_token_int8", "w4a16_gemm", "flash_prefill"),
                         ("megakernel_token", "megakernel_chunk", "flash_decode_int8",
                          "cache_append_int8")),
    "stacked_int8": ("1", ("w4a16_gemv", "w4a16_gemm", "flash_decode_int8", "flash_prefill",
                           "cache_append_int8"),
                     ("megakernel_token", "megakernel_token_int8", "megakernel_chunk",
                      "flash_decode")),
    # the W3 model (phase 3e): the megakernels' W3 modes, prompts over 32
    # tokens on K1's W3 GEMM and K3 (and the head after them on its GEMV);
    # no W4 kernel anywhere
    "megakernels_w3": (None, ("megakernel_token_w3", "megakernel_chunk_w3", "w3a16_gemm",
                              "flash_prefill"),
                       ("megakernel_token", "megakernel_chunk", "w4a16_gemv", "w4a16_gemm",
                        "flash_decode")),
    "stacked_w3": ("1", ("w3a16_gemv", "w3a16_gemm", "flash_decode", "flash_prefill"),
                   ("megakernel_token_w3", "megakernel_chunk_w3", "w4a16_gemv",
                    "w4a16_gemm")),
    # the int8-activation prefill (phase 3f): with the int8 weight cache,
    # every prefill over 32 tokens on K11 (no K1 GEMM, no K10); with
    # prefill_a8 alone, the 1000-token prompt on K10 and the 200-token one
    # on K1's GEMM; prompts of up to 32 tokens on K5, decode on K4
    "prefill_w8": (None, ("megakernel_token", "megakernel_chunk", "w8a8_gemm",
                          "quant_per_token", "flash_prefill"), ("w4a8_gemm", "w4a16_gemm")),
    "prefill_a8": (None, ("megakernel_token", "megakernel_chunk", "w4a8_gemm", "w4a16_gemm",
                          "quant_per_token", "flash_prefill"), ("w8a8_gemm",)),
    # Falcon-7B (phase 3h): the stacked path, decode through K14 per layer
    # (K2's gate fails: 71 q heads a kv head at head_dim 64), prefill on K1's
    # GEMM and K3's head_dim-64 mode; no megakernel
    "falcon": (None, ("w4a16_gemv", "w4a16_gemm", "flash_decode_layer", "flash_prefill"),
               ("megakernel_token", "megakernel_chunk", "flash_decode", "flash_decode_int8",
                "cache_append")),
    # MPT-7B (phase 3j): decode on K4's MPT shape, every prompt on the stacked
    # prefill (K5 takes the llama shape only): K1's GEMM, K3 with slopes, the
    # head's GEMV after it; no attention kernel without slopes
    "mpt": (None, ("megakernel_token_mpt", "w4a16_gemm", "w4a16_gemv", "flash_prefill_alibi"),
            ("megakernel_token", "megakernel_chunk", "flash_decode", "flash_prefill",
             "flash_decode_alibi", "flash_decode_layer_alibi")),
    "mpt_stacked": ("1", ("w4a16_gemv", "w4a16_gemm", "flash_decode_alibi",
                          "flash_prefill_alibi"),
                    ("megakernel_token_mpt", "megakernel_token", "megakernel_chunk",
                     "flash_decode", "flash_prefill", "flash_decode_layer_alibi")),
    # phase 3l: OPT-6.7B and Pythia-6.9B decode on K2 (MHA, head_dim 128),
    # StarCoder on K14 (48 q heads over one kv head, wider than K2's
    # decode_attn unit), each split by the length it reads under the graph;
    # every prompt on K1's GEMM and K3; no megakernel (JAX's gates refuse
    # the three)
    **{fam: (None, ("w4a16_gemv", "w4a16_gemm", dec, "flash_prefill"),
             ("megakernel_token", "megakernel_token_mpt", "megakernel_chunk",
              "megakernel_batched", off, "flash_decode_int8", "flash_decode_alibi",
              "flash_prefill_alibi"))
       for fam, dec, off in (("opt", "flash_decode", "flash_decode_layer"),
                             ("starcoder", "flash_decode_layer", "flash_decode"),
                             ("pythia", "flash_decode", "flash_decode_layer"))},
    # BLOOM-560m (phase 4): the stacked path, decode on K14 with slopes (the
    # single-position step keeps K14 at head_dim 64; the per-row steps take
    # K2, K8 and K9), prompts on K1's GEMM and K3 with slopes
    "bloom": (None, ("w4a16_gemm", "flash_decode_layer_alibi", "flash_prefill_alibi"),
              ("megakernel_token", "megakernel_token_mpt", "flash_decode", "flash_prefill",
               "flash_decode_layer", "flash_decode_alibi")),
}


def counters():
    from awq_tpu_torch.ops import cache_append as ca
    from awq_tpu_torch.ops import decode_attn as da
    from awq_tpu_torch.ops import megakernel as mk
    from awq_tpu_torch.ops import megakernel_batched as mkb
    from awq_tpu_torch.ops import megakernel_chunk as mkc
    from awq_tpu_torch.ops import megakernel_tp as mtp
    from awq_tpu_torch.ops import w4a16 as w4
    from awq_tpu_torch.ops import w8a8 as q8

    return (w4.LAUNCHES, da.LAUNCHES, mk.LAUNCHES, mkc.LAUNCHES, mkb.LAUNCHES,
            ca.LAUNCHES, q8.LAUNCHES, mtp.LAUNCHES)


def reset_counters():
    for d in counters():
        for k in d:
            d[k] = 0


def read_counters():
    return {k: v for d in counters() for k, v in d.items()}


def set_config(disable):
    if disable is None:
        os.environ.pop("AWQ_TPU_DISABLE_MEGAKERNEL", None)
    else:
        os.environ["AWQ_TPU_DISABLE_MEGAKERNEL"] = disable


def cache_bytes(cache) -> int:
    from awq_tpu_torch.models.llama import cache_tensors

    return sum(t.numel() * t.element_size() for t in cache_tensors(cache))


def phase_serve(torch, layers: int):
    """Phase 3: the requests through InferenceEngine, once per configuration;
    returns {config: launches}, the engine's parameters (fused, W4 head) for
    the batched phases and the greedy ids on the megakernels."""
    from awq_tpu_torch.config import ModelConfig, QuantConfig, RuntimeConfig
    from awq_tpu_torch.models.llama import init_qparams
    from awq_tpu_torch.runtime.engine import InferenceEngine

    cfg = ModelConfig(**{**LLAMA3_8B, "num_layers": layers})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_qparams(cfg, QuantConfig(w_bit=4, group_size=G),
                          torch.Generator(device="cuda").manual_seed(0))
    engine = InferenceEngine(cfg, params,
                             RuntimeConfig(max_seq_len=2048, quantize_head=True))
    del params
    torch.cuda.synchronize()
    log(f"  model: {layers} layers at Llama-3-8B width, W4 weights+head "
        f"{weight_bytes(engine.params) / 1e9:.3f} GB, embedding "
        f"{engine.params['embed'].numel() * 2 / 1e9:.3f} GB, KV cache "
        f"{cache_bytes(engine.cache) / 1e9:.3f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()      # serving's peak, the build left out
    out_launches, ids, ttft = serve_single(torch, engine, cfg, ("megakernels", "stacked"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  peak device memory while serving {peak:.2f} GiB")
    params = engine.params
    del engine
    torch.cuda.empty_cache()
    return out_launches, cfg, params, ids["megakernels"], peak, ttft["megakernels"]


def serve_single(torch, engine, cfg, labels):
    """Phase 3's four requests through ``engine`` once per path of
    ``labels`` (SERVE_PATHS), three times:

    1. the main path's run: the launch counts set to 0 just before, the
       requests under torch.profiler, the launches read just after. On a
       card a decode burst replays a captured step, which calls no wrapper:
       the wrappers' counts (their calls: the prefills, and a bucket's
       warm-up step and capture) are printed, and a kernel that a replay
       holds counts the kernels of its symbol in the device trace
       (``trace_launches``); one that no graph holds (a prefill's) counts
       its wrapper calls, which are its launches. The trace is held to the
       launches these imply (``trace_short``, printed: CUPTI can drop a
       record). The calls and the launches must be non-zero for the path's
       kernels and zero for the kernels off it;
    2. unprofiled, on the graphs the first run captured: TTFT and ms/token,
       the ids equal to the first run's;
    3. with the engine's loop taken away: the forward loop (a ``forward``
       call a token at a host position, the decode of the engine before the
       graphs). Its ids must equal the graph's bit for bit on every path: K4
       splits its attention by the position it reads, and so do the stacked
       path's K2, K9 and K14 (their grids planned for the burst's bucket),
       as the forward loop plans each length on the host.

    Then the host's time to queue a replay, a profile of replayed steps and
    the graphs' count, capture time and pool. Returns {label: launches},
    {label: the requests' greedy ids} and {label: their TTFTs, ms}."""
    from awq_tpu_torch.config import GenConfig
    from awq_tpu_torch.models.llama import decode_step_on_k4

    wbytes = weight_bytes(engine.params)
    kv_row = cache_bytes(engine.cache) // engine.max_seq_len   # bytes/position
    gen = GenConfig(greedy=True, max_new_tokens=32)
    prompts = request_prompts(cfg)
    loop = engine.loop

    def run():
        ids_all, tms, spans = [], [], []
        for i, ((n, fresh), prompt) in enumerate(zip(REQUESTS, prompts)):
            if fresh:
                engine.reset()
            start = engine.start_pos
            out = engine.generate(prompt, gen)
            ids = out["output_ids"]
            if len(ids) != 32 or int(ids.min()) < 0 or int(ids.max()) >= cfg.vocab_size:
                raise AssertionError(f"request {i + 1}: bad output ids {ids.tolist()}")
            ids_all.append(ids.tolist())
            tms.append(out["timing"])
            spans.append((start, engine.start_pos))
        return ids_all, tms, spans

    out_launches, out_ids, out_ttft = {}, {}, {}
    for label in labels:
        disable, must, off = SERVE_PATHS[label]
        set_config(disable)
        on_k4 = decode_step_on_k4(engine.params, engine.cfg, engine.cache, 1)
        log(f"  [{label}] AWQ_TPU_DISABLE_MEGAKERNEL={disable or 'unset'}; decode loop: "
            f"{'graph (a captured step replayed a token)' if loop else 'forward'}")
        engine.warmup()
        before = set(loop.graphs) if loop is not None else set()
        reset_counters()
        prof, (ids_all, tms, _) = traced(torch, run)
        calls = read_counters()
        captured = len(set(loop.graphs) - before) if loop is not None else 0
        t0 = time.perf_counter()
        launches = trace_launches(prof, calls)
        del prof
        log(f"  [{label}] main path's run (profiled): decode loop "
            f"{sorted({tm['loop'] for tm in tms})}, {captured} graphs captured; wrapper calls "
            f"{nonzero(calls)}; device launches (trace, {time.perf_counter() - t0:.1f} s to "
            f"read) {nonzero(launches)}")
        log(f"  [{label}] greedy ids: {json.dumps(ids_all)}")
        check_path(label + " (wrapper calls)", calls, must, off)

        again, tms, spans = run()
        if again != ids_all:
            compare_ids(f"{label} replayed", again, ids_all, "the main path's run")
            raise AssertionError(f"[{label}] the unprofiled run's ids differ")
        for i, ((n, _), tm, (start, end)) in enumerate(zip(REQUESTS, tms, spans)):
            fed = end - start - 31                       # prompt plus a pending id
            gb_tok = (wbytes + kv_row * (start + fed + 16)) / 1e9
            ms_tok = tm["ms_per_token"]
            log(f"  [{label} {tm['loop']}] request {i + 1}: prompt {n} (+{fed - n} pending) at "
                f"start_pos {start}: TTFT {tm['ttft_s'] * 1e3:.2f} ms, {ms_tok:.3f} "
                f"ms/token over 31 decode steps, {gb_tok:.3f} GB/token streamed, "
                f"{gb_tok / ms_tok * 1e3:.1f} GB/s effective")
        ms_graph = tms[-1]["ms_per_token"]
        out_ttft[label] = [tm["ttft_s"] * 1e3 for tm in tms]

        if loop is not None:
            engine.loop = None
            try:
                fwd, ftms, _ = run()
            finally:
                engine.loop = loop
            log(f"  [{label} forward] ms/token by request: "
                + " / ".join(f"{tm['ms_per_token']:.3f}" for tm in ftms)
                + " (the forward loop: done read after every step)")
            if fwd == ids_all:
                log(f"  [{label}] the graph's greedy ids equal the forward loop's for all "
                    f"{len(fwd)} requests, bit for bit ({'K4' if on_k4 else 'the stacked path'})")
            else:
                compare_ids(f"{label} forward", fwd, ids_all, "the graph's")
                raise AssertionError(f"[{label}] the graph's ids differ from the forward "
                                     "loop's")
            per_step = profile_replays(torch, engine, cfg, label, ms_graph, calls)
            # a kernel that no graph holds launches where its wrapper is
            # called: its calls are its launches, and the trace's count of
            # it only checks the trace
            steps = len(REQUESTS) * (gen.max_new_tokens - 1)
            short = trace_short(launches, calls, per_step, steps, captured)
            launches = {k: (v if per_step.get(k) else calls.get(k, v))
                        for k, v in launches.items()}
            log(f"  [{label}] launches: the wrapper calls of the kernels no graph holds, the "
                f"trace's count of those a replay holds ({nonzero(per_step)} a replay, "
                f"{steps - captured} of the {steps} decode steps replays): "
                f"{nonzero(launches)}; "
                + (f"the trace is short of the launches this implies: {short} (CUPTI drops "
                   "records)" if short else "the trace holds every launch this implies"))
        check_path(label, launches, must, off)
        out_launches[label], out_ids[label] = launches, ids_all
    set_config(None)
    return out_launches, out_ids, out_ttft


def nonzero(d):
    return {k: v for k, v in d.items() if v}


def traced(torch, fn):
    """``fn()`` under torch.profiler (device activity), the device drained
    and left idle a moment before and after it; returns the profiler and
    ``fn``'s result."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(0.05)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    return prof, out


def trace_short(launches, calls, per_step, steps, captured):
    """Where a run's trace holds another count of kernels than the run
    launched. A counter's launches are its wrapper calls (the prefills',
    and each captured graph's warm-up step and capture, which runs nothing)
    plus, for each of the ``steps`` decode steps that was no warm-up, the
    launches a replay holds (``per_step``, from a trace of replays,
    rounded): {counter: (traced, implied)} where the two differ."""
    out = {}
    for k, n in launches.items():
        if k in TRACE_SYMBOLS and (calls.get(k) or per_step.get(k)):
            want = calls.get(k, 0) + (steps - 2 * captured) * round(per_step.get(k, 0))
            if n != want:
                out[k] = (n, want)
    return out


# each launch counter's kernel: a regex on the symbol a device trace shows
# (the kernel that one wrapper call launches once; a split-K reduce or an
# epilogue after it is not counted). W3 and MPT units share their llama W4
# symbols, and the ALiBi modes of K2, K3 and K14 their kernels' (the slopes
# are an argument): a symbol that several counters match counts for the one
# the run called.
TRACE_SYMBOLS = {
    "megakernel_token": r"token_kernel<(float|__nv_bfloat16|__half), 0>",
    "megakernel_token_w3": r"token_kernel<(float|__nv_bfloat16|__half), 0>",
    "megakernel_token_mpt": r"token_kernel<(float|__nv_bfloat16|__half), 0>",
    "megakernel_token_int8": r"token_kernel<(signed )?char, 0>",
    "megakernel_chunk": r"chunk_kernel<", "megakernel_chunk_w3": r"chunk_kernel<",
    "w4a16_gemv": r"w4a16_gemv_kernel<[^,<>]+, false",
    "w3a16_gemv": r"w4a16_gemv_kernel<[^,<>]+, true",
    "w4a16_gemm": r"w4a16_wgmma_kernel<[^,<>]+, [^,<>]+, false",
    "w3a16_gemm": r"w4a16_wgmma_kernel<[^,<>]+, [^,<>]+, true",
    "flash_decode": r"flash_decode_kernel<.*ContigKV",
    "flash_decode_alibi": r"flash_decode_kernel<.*ContigKV",
    "flash_decode_layer_alibi": r"flash_decode_kernel<.*LayerKV",
    "flash_prefill_alibi": r"flash_prefill(_wgmma)?_kernel",
    "flash_decode_int8": r"flash_decode_kernel<.*Int8KV",
    "flash_decode_layer": r"flash_decode_kernel<.*LayerKV",
    "flash_prefill": r"flash_prefill(_wgmma)?_kernel",
    "cache_append": r"cache_append_kernel", "cache_append_int8": r"cache_append_int8_kernel",
    "w8a8_gemm": r"w8a8_wgmma_kernel", "w4a8_gemm": r"w4a8_wgmma_kernel",
    "quant_per_token": r"quant_per_token_kernel",
}


# the appends fused into K2, K8 and K9: every launch of these counters' kernels
# appends, so a device trace counts the append's launches as theirs (and
# the standalone K7's symbol, which the path no longer launches, beside);
# the kernels line gives K7's entries the first of these launches whose
# case has the entry's shape (``pick``)
FUSED_APPEND = {"cache_append": ("flash_decode", "flash_decode_alibi", "flash_decode_wide"),
                "cache_append_paged": ("flash_decode_paged", "flash_decode_paged_alibi",
                                       "flash_decode_paged_wide"),
                "cache_append_int8": ("flash_decode_int8", "flash_decode_int8_alibi",
                                      "flash_decode_int8_wide")}


def trace_launches(prof, calls):
    """The launches of a profiled run by counter: each counter of
    TRACE_SYMBOLS counts the device trace's kernels of its symbol (where
    several match, the one the wrappers called in the run, ``calls``);
    other counters keep their calls. K7's counters add the launches of the
    attention kernels that append (FUSED_APPEND)."""
    import re
    from collections import Counter

    from torch.autograd import DeviceType

    names = Counter(e.name for e in prof.events() if e.device_type == DeviceType.CUDA)
    out = {k: (0 if k in TRACE_SYMBOLS else v) for k, v in calls.items()}
    for name, n in names.items():
        keys = [k for k, pat in TRACE_SYMBOLS.items() if re.search(pat, name)]
        called = [k for k in keys if calls.get(k)]
        if len(called) > 1:
            raise AssertionError(f"the trace's {name} matches the counters {called}")
        for k in called or keys:
            out[k] = out.get(k, 0) + n
    for k, attention in FUSED_APPEND.items():
        out[k] = out.get(k, 0) + sum(out.get(a, 0) for a in attention)
    return out


def request_prompts(cfg):
    """Phase 3's four prompts (the generator ``serve_single`` draws them from)."""
    import torch

    rng = torch.Generator().manual_seed(7)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
            for n, _ in REQUESTS]


def profile_replays(torch, engine, cfg, label, ms_ref: float, calls, steps: int = 16):
    """After the requests: the host's time to queue ``steps`` replays of the
    engine's captured step at the dialogue's end (no sync between), a
    profile of ``steps`` replays (device time, kernels, idle share against
    ``ms_ref``), and the loop's graphs: count, capture seconds and pool.
    Returns each counter's launches a replay, from that profile (a symbol
    that several counters match counts for the one in ``calls``)."""
    from awq_tpu_torch.config import GenConfig
    from awq_tpu_torch.runtime.generate import plan_bound

    loop = engine.loop
    pos = engine.start_pos
    first = torch.zeros((1,), dtype=torch.long, device="cuda")
    seen = torch.zeros((1, cfg.vocab_size), dtype=torch.bool, device="cuda")
    loop.begin(first, pos, [], seen, GenConfig(greedy=True),
               plan_bound(engine.max_seq_len, pos + 2 * steps + 2))
    loop.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loop.step()
    host = (time.perf_counter() - t0) / steps * 1e3
    torch.cuda.synchronize()
    dev_ms = (time.perf_counter() - t0) / steps * 1e3
    log(f"  [{label} graph] host {host:.3f} ms a step to queue {steps} replays at position "
        f"{pos + 1}, {dev_ms:.3f} ms a step to the last one's end")
    prof = profile_steps(torch, lambda i: loop.step(), ms_ref, f"{label} graph",
                         f"position {pos + steps + 1}", "ms/token", steps)
    log(f"  [{label}] graphs so far: {len(loop.graphs)} captured (one a length bucket and "
        f"path), {loop.capture_s * 1e3:.1f} ms of capture, pool "
        f"{loop.pool_bytes / 2**20:.1f} MiB")
    engine.reset()
    return {k: v / steps for k, v in trace_launches(prof, calls).items()
            if k in TRACE_SYMBOLS and v}


def phase_serve_checkpoint(torch, layers: int, single_ids):
    """Phase 3i: phase 3's model (``init_qparams`` from seed 0, W4 g128)
    saved with the port's ``save_checkpoint`` under ``build/``, loaded back
    (every array equal), then served: an ``InferenceEngine`` with a W4 head
    over the loaded checkpoint takes phase 3's four requests as
    ``serve_single`` drives them (the graph's ids equal to phase 3's and to
    the forward loop's), one sampled round on the graph and on the forward
    loop from one seed (ids equal), then behind ``ModelWorker`` as
    ``input_ids`` over HTTP (localhost), each reply's ids equal to phase
    3's. Last, K4 with
    its position in device memory against the host-length launch at the
    served lengths."""
    import shutil

    from awq_tpu_torch.config import GenConfig, ModelConfig, QuantConfig, RuntimeConfig
    from awq_tpu_torch.models.llama import init_qparams
    from awq_tpu_torch.runtime.engine import InferenceEngine
    from awq_tpu_torch.serve.http import post_stream
    from awq_tpu_torch.serve.worker import ModelWorker
    from awq_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    cfg = ModelConfig(**{**LLAMA3_8B, "num_layers": layers})
    qcfg = QuantConfig(w_bit=4, group_size=G)
    params = init_qparams(cfg, qcfg, torch.Generator(device="cuda").manual_seed(0))
    out_dir = Path(__file__).resolve().parent / "build" / "smoke_checkpoint"
    shutil.rmtree(out_dir, ignore_errors=True)
    path = str(out_dir / "llama3_8b_w4_random")
    t0 = time.perf_counter()
    nbytes = save_checkpoint(path, params, cfg, qcfg)
    t1 = time.perf_counter()
    loaded, lcfg, lq = load_checkpoint(path)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"  checkpoint: {nbytes / 1e9:.3f} GB written in {t1 - t0:.2f} s, loaded onto the card "
        f"in {t2 - t1:.2f} s (the page cache warm: just written)")

    def same(a, b, at="params"):
        if isinstance(a, dict):
            if sorted(a) != sorted(b):
                raise AssertionError(f"{at}: keys differ")
            for k in a:
                same(a[k], b[k], f"{at}/{k}")
        elif isinstance(a, torch.Tensor):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"{at}: arrays differ")
        elif hasattr(a, "qweight"):
            for f in ("qweight", "scales", "szeros"):
                same(getattr(a, f), getattr(b, f), f"{at}.{f}")
            if (a.w_bit, a.group_size, a.dense3) != (b.w_bit, b.group_size, b.dense3):
                raise AssertionError(f"{at}: formats differ")
        elif a is not None or b is not None:
            raise AssertionError(f"{at}: {type(a).__name__} against {type(b).__name__}")

    same(loaded, params)
    if lcfg != cfg or lq != qcfg:
        raise AssertionError("the loaded configs differ")
    log("  checkpoint: every array and both configs equal the saved ones")
    del params
    engine = InferenceEngine(lcfg, loaded, RuntimeConfig(max_seq_len=2048, quantize_head=True))
    del loaded
    shutil.rmtree(out_dir, ignore_errors=True)
    launches, ids, _ = serve_single(torch, engine, cfg, ("megakernels",))
    if ids["megakernels"] != single_ids:
        compare_ids("checkpoint", ids["megakernels"], single_ids, "phase 3's")
        raise AssertionError("the loaded checkpoint's ids differ from phase 3's")
    log("  [checkpoint] the four requests' ids equal phase 3's, bit for bit")
    # a sampled round (the worker's default sampling) replayed on its own
    # graph, against the forward loop from the same seed
    sgen = GenConfig(temperature=0.7, top_p=0.9, top_k=40, max_new_tokens=32)
    loop, got = engine.loop, {}
    for mode in ("graph", "forward"):
        engine.reset()
        engine.loop = loop if mode == "graph" else None
        try:
            out = engine.generate(request_prompts(cfg)[0], sgen,
                                  generator=torch.Generator(device="cuda").manual_seed(21))
        finally:
            engine.loop = loop
        if out["timing"]["loop"] != mode:
            raise AssertionError(f"[sampled] the decode ran {out['timing']['loop']}, not {mode}")
        got[mode] = out["output_ids"].tolist()
        log(f"  [sampled {mode}] {out['timing']['ms_per_token']:.3f} ms/token over 31 steps "
            f"(temperature 0.7, top-p 0.9, top-k 40, seed 21): {got[mode]}")
    if got["graph"] != got["forward"]:
        raise AssertionError("[sampled] the graph's ids differ from the forward loop's")
    log("  [sampled] the graph's ids equal the forward loop's from the same seed, bit for bit")
    engine.warmup()
    worker = ModelWorker(engine, "llama3-8b-w4-random", port=0)
    worker.start()
    try:
        got = []
        for (n, fresh), prompt in zip(REQUESTS, request_prompts(cfg)):
            chunks = list(post_stream(worker.url + "/worker_generate_stream", dict(
                input_ids=prompt, greedy=True, max_new_tokens=32, stream_interval=8,
                continue_dialogue=not fresh), timeout=300))
            last = chunks[-1]
            if last.get("error_code") or not last.get("finished"):
                raise AssertionError(f"worker: request of {n} tokens answered {last}")
            got.append(last["ids"])
            tm = last["timing"]
            log(f"  [worker] request of {n} tokens: {len(chunks)} chunks, TTFT "
                f"{tm['ttft_s'] * 1e3:.2f} ms, {tm['ms_per_token']:.3f} ms/token streamed "
                f"(ids read every 8 steps), decode loop {tm['loop']}")
    finally:
        worker.stop()
    if got != single_ids:
        compare_ids("worker", got, single_ids, "phase 3's")
        raise AssertionError("worker: the streamed ids differ from phase 3's")
    log("  [worker] the four replies' ids equal phase 3's, bit for bit")
    k4_bucket_cost(torch, engine, cfg)
    del engine, worker
    torch.cuda.empty_cache()
    return {"checkpoint": launches["megakernels"]}


def k4_bucket_cost(torch, engine, cfg) -> None:
    """K4 (the served model's, W4 head in the kernel) at lengths 48, 300 and
    1000, given the length as a host int against the position in device
    memory with the workspace sized for the bucket the served requests take
    there (256, 512, 2048 positions) and for the whole cache: the outputs
    bit-equal, and CUDA event medians of 20 calls, L2 flushed."""
    from awq_tpu_torch.models.llama import _rope_cached
    from awq_tpu_torch.ops import megakernel as mk

    la = engine.params["layers"]
    args = (la["wqkv"], la["wo"], la["wgateup"], la["down"], la["ln1"], la["ln2"])
    kw = dict(nq=cfg.num_heads, nkv=cfg.num_kv_heads, eps=cfg.rms_eps,
              whead=engine.params["lm_head"], norm_w=engine.params["norm"])
    cos, sin = _rope_cached(cfg, engine.max_seq_len, torch.device("cuda"))
    h = torch.zeros((1, cfg.hidden_size), dtype=torch.bfloat16, device="cuda")
    timer = Timer(torch, reps=20)
    for length, bucket in ((48, 255), (300, 511), (1000, 2047)):
        pos = torch.tensor([length], dtype=torch.int32, device="cuda")
        exact = timer(lambda: mk.w4a16_llama_token_step(h, *args, cos[length], sin[length],
                                                        engine.cache, length, **kw))
        at_bucket = timer(lambda: mk.w4a16_llama_token_step(h, *args, cos, sin, engine.cache,
                                                            pos, max_length=bucket, **kw))
        at_full = timer(lambda: mk.w4a16_llama_token_step(h, *args, cos, sin, engine.cache, pos,
                                                          max_length=engine.max_seq_len - 1,
                                                          **kw))
        k4_same(f"megakernel_token len={length} bucket {bucket + 1}",
                mk.w4a16_llama_token_step(h, *args, cos, sin, engine.cache, pos,
                                          max_length=bucket, **kw),
                mk.w4a16_llama_token_step(h, *args, cos[length], sin[length], engine.cache,
                                          length, **kw))
        log(f"  K4 at length {length}: {exact:.4f} ms given the length as a host int, "
            f"{at_bucket:.4f} ms with the position in device memory (workspace for its bucket "
            f"of {bucket + 1} positions), {at_full:.4f} ms (workspace for the whole cache)")


def phase_serve_falcon(torch, layers: int):
    """Phase 3h: Falcon-7B at full width (``layers`` of its 32), random
    W4-g64 weights from seed 0 through ``init_qparams``, a W4-g64 head
    (``quantize_head``) and a bf16 cache of 2048 positions, serving phase 3's
    four requests through ``InferenceEngine`` (greedy, 32 new tokens each).
    Returns {"falcon": launches}."""
    from awq_tpu_torch.config import ModelConfig, QuantConfig, RuntimeConfig
    from awq_tpu_torch.models.llama import init_qparams
    from awq_tpu_torch.runtime.engine import InferenceEngine

    cfg = ModelConfig(**{**FALCON_7B, "num_layers": layers})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_qparams(cfg, QuantConfig(w_bit=4, group_size=FALCON_G),
                          torch.Generator(device="cuda").manual_seed(0))
    engine = InferenceEngine(cfg, params,
                             RuntimeConfig(max_seq_len=2048, quantize_head=True))
    del params
    torch.cuda.synchronize()
    head = engine.params["lm_head"]
    log(f"  model: Falcon-7B, {layers} layers, W4-g{FALCON_G} weights+head "
        f"{weight_bytes(engine.params) / 1e9:.3f} GB (head g{head.group_size}), embedding "
        f"{engine.params['embed'].numel() * 2 / 1e9:.3f} GB, KV cache "
        f"{cache_bytes(engine.cache) / 1e9:.4f} GB (one kv head), built in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()      # serving's peak, the build left out
    launches, ids, _ = serve_single(torch, engine, cfg, ("falcon",))
    steps = len(REQUESTS) * 31                  # decode steps: 32 new tokens a request
    per_step = round(launches["falcon"]["flash_decode_layer"] / steps)
    log(f"  [falcon] K14 launches per decode step {per_step:g} (one per layer), K3 launches "
        f"per prompt {launches['falcon']['flash_prefill'] / len(REQUESTS):g}")
    if per_step != layers:
        raise AssertionError(f"[falcon] {per_step:g} K14 launches per decode step, not {layers}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  [falcon] peak device memory while serving {peak:.2f} GiB")
    for i, row in enumerate(ids["falcon"]):
        log(f"  [falcon] request {i + 1} ids: {row}")
    del engine
    torch.cuda.empty_cache()
    return launches


def phase_serve_mpt(torch, layers: int):
    """Phase 3j: MPT-7B at full width (``layers`` of its 32), random W4-g128
    weights from seed 0 through ``init_qparams`` (``zero_mean``), the tied embedding as the
    head quantized to W4-g128 (``quantize_head``) and a bf16 cache of 2048
    positions, serving phase 3's four requests through ``InferenceEngine``
    (greedy, 32 new tokens each) as ``serve_single`` drives them: decode on
    K4's MPT shape under the graph (one K4 launch a token, counted in the
    device trace; the forward loop's ids equal the graph's), and on the
    stacked path (``AWQ_TPU_DISABLE_MEGAKERNEL=1``: K1, K2 with slopes) under
    the graph; then the four requests behind ``ModelWorker`` over HTTP, whose
    ids must equal the K4 run's. Returns {"mpt": launches, "mpt_stacked":
    launches}."""
    from awq_tpu_torch.config import ModelConfig, QuantConfig, RuntimeConfig
    from awq_tpu_torch.models.llama import init_qparams
    from awq_tpu_torch.runtime.engine import InferenceEngine
    from awq_tpu_torch.serve.http import post_stream
    from awq_tpu_torch.serve.worker import ModelWorker

    cfg = ModelConfig(**{**MPT_7B, "num_layers": layers})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = zero_mean(init_qparams(cfg, QuantConfig(w_bit=4, group_size=G),
                                    torch.Generator(device="cuda").manual_seed(0)), 4)
    params["lm_head"] = params["embed"].T.contiguous()     # the tied head, quantized below
    engine = InferenceEngine(cfg, params, RuntimeConfig(max_seq_len=2048, quantize_head=True))
    del params
    torch.cuda.synchronize()
    log(f"  model: MPT-7B, {layers} layers, W4-g{G} weights + the tied embedding as a W4 head "
        f"{weight_bytes(engine.params) / 1e9:.3f} GB, embedding "
        f"{engine.params['embed'].numel() * 2 / 1e9:.3f} GB, KV cache "
        f"{cache_bytes(engine.cache) / 1e9:.4f} GB (32 kv heads), built in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()      # serving's peak, the build left out
    launches, ids, _ = serve_single(torch, engine, cfg, ("mpt", "mpt_stacked"))
    steps = len(REQUESTS) * 31                  # decode steps: 32 new tokens a request
    per_step = launches["mpt"]["megakernel_token_mpt"] / steps
    log(f"  [mpt] K4 launches per decode step {per_step:.3f} (the device trace's count over "
        f"{steps} steps: the replays, plus each graph's warm-up step); K3 launches per prompt "
        f"{launches['mpt']['flash_prefill_alibi'] / len(REQUESTS):g}; stacked: K2 launches per "
        f"decode step {launches['mpt_stacked']['flash_decode_alibi'] / steps:.3f}")
    if round(per_step) != 1:
        raise AssertionError(f"[mpt] {per_step:.3f} K4 launches a decode step, not 1")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  [mpt] peak device memory while serving {peak:.2f} GiB")
    engine.warmup()
    worker = ModelWorker(engine, "mpt-7b-w4-random", port=0)
    worker.start()
    try:
        got = []
        for (n, fresh), prompt in zip(REQUESTS, request_prompts(cfg)):
            chunks = list(post_stream(worker.url + "/worker_generate_stream", dict(
                input_ids=prompt, greedy=True, max_new_tokens=32, stream_interval=8,
                continue_dialogue=not fresh), timeout=300))
            last = chunks[-1]
            if last.get("error_code") or not last.get("finished"):
                raise AssertionError(f"[mpt worker] request of {n} tokens answered {last}")
            got.append(last["ids"])
            tm = last["timing"]
            log(f"  [mpt worker] request of {n} tokens: {len(chunks)} chunks, TTFT "
                f"{tm['ttft_s'] * 1e3:.2f} ms, {tm['ms_per_token']:.3f} ms/token streamed, "
                f"decode loop {tm['loop']}")
    finally:
        worker.stop()
    if got != ids["mpt"]:
        compare_ids("mpt worker", got, ids["mpt"], "phase 3j's on K4")
        raise AssertionError("[mpt worker] the streamed ids differ from phase 3j's")
    log("  [mpt worker] the four replies' ids equal phase 3j's on K4, bit for bit")
    for i, row in enumerate(ids["mpt"]):
        log(f"  [mpt] request {i + 1} ids: {row}")
    del engine, worker
    torch.cuda.empty_cache()
    return launches


def compare_ids(label, got, ref, what):
    """Information, not a check: how many requests' greedy ids equal
    ``ref``'s, and each request's first differing step (None: equal)."""
    first = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                  None if len(a) == len(b) else min(len(a), len(b)))
             for a, b in zip(got, ref)]
    log(f"  [{label}] greedy ids equal {what} for {first.count(None)}/{len(ref)} requests; "
        f"first differing step by request: {first}")


def phase_serve_int8(torch, cfg, params, single_ids, slot_ids, slot_peak):
    """Phase 3d, the int8 KV cache (KVCache8): phase 3's four requests
    through InferenceEngine(cache_dtype="int8") on K4's int8 mode and on the
    stacked path (K9 and its int8 append), then phase 3b's twelve through an
    8-slot BatchEngine(cache_dtype="int8") on K6's int8 mode and on the
    stacked path. Prints the caches' bytes, the peak device memory against
    phase 3b's and how many requests' greedy ids equal the bf16 runs' (on
    the megakernels). Returns {config: launches} and the 8-slot int8 engine's
    greedy ids on K6 (phase 3m's reference)."""
    from awq_tpu_torch.config import RuntimeConfig
    from awq_tpu_torch.runtime.engine import InferenceEngine

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngine(cfg, params, RuntimeConfig(max_seq_len=2048), cache_dtype="int8")
    log(f"  single-stream int8 cache: {cache_bytes(engine.cache) / 2**30:.4f} GiB (codes "
        f"{engine.cache.data.numel() / 2**30:.4f}, scales "
        f"{engine.cache.scales.numel() * 4 / 2**30:.4f})")
    out_launches, ids, _ = serve_single(torch, engine, cfg,
                                        ("megakernels_int8", "stacked_int8"))
    for label in ids:
        compare_ids(label, ids[label], single_ids, "phase 3's on the bf16 megakernels")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del engine
    batched, bids, peaks = phase_serve_batched(torch, cfg, params, "int8")
    out_launches.update(batched)
    for label in bids:
        compare_ids(label, bids[label], slot_ids, "phase 3b's on the bf16 K6")
        log(f"  [{label}] peak device memory {peaks[label]:.2f} GiB against "
            f"{slot_peak:.2f} GiB for phase 3b's bf16 engine on K6")
    return out_launches, bids["batched_int8"]


def phase_serve_w3(torch, layers, w4, single_ids, slot_ids):
    """Phase 3e, the W3 model: W3-g128 weights in pack_int3 and a W3 head
    from ``quantize_head``, at ``layers`` layers of Llama-3-8B's width.
    Phase 3's four requests through InferenceEngine and phase 3b's twelve
    through an 8-slot BatchEngine, each on the megakernels' W3 modes (K4,
    K5, K6) and with ``AWQ_TPU_DISABLE_MEGAKERNEL=1`` (K1's W3 mode); then
    the twelve once more on K6's int8 and paged W3 modes. ``w4`` holds
    phase 3's and 3b's W4 weight bytes and peak memory. Prints the weight
    bytes and peak device memory against W4 and how many requests' greedy
    ids equal the W4 runs' (information: W3 changes the numbers). Returns
    {config: launches}."""
    from awq_tpu_torch.config import ModelConfig, QuantConfig, RuntimeConfig
    from awq_tpu_torch.models.llama import init_qparams
    from awq_tpu_torch.runtime.engine import InferenceEngine
    from awq_tpu_torch.runtime.paged import PagedBatchEngine

    cfg = ModelConfig(**{**LLAMA3_8B, "num_layers": layers})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_qparams(cfg, QuantConfig(w_bit=3, group_size=G),
                          torch.Generator(device="cuda").manual_seed(0))
    engine = InferenceEngine(cfg, params,
                             RuntimeConfig(max_seq_len=2048, quantize_head=True))
    del params
    torch.cuda.synchronize()
    w3_bytes = weight_bytes(engine.params)
    log(f"  model: {layers} layers at Llama-3-8B width, W3 (pack_int3) weights+head "
        f"{w3_bytes / 1e9:.3f} GB against {w4['weight_bytes'] / 1e9:.3f} GB in W4 "
        f"({w3_bytes / w4['weight_bytes']:.3f}x), built in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()      # serving's peak, as phase 3's
    out_launches, ids, _ = serve_single(torch, engine, cfg, ("megakernels_w3", "stacked_w3"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  peak device memory while serving {peak:.2f} GiB against "
        f"{w4['single_peak']:.2f} GiB for phase 3's W4 engine")
    for label in ids:
        compare_ids(label, ids[label], single_ids, "phase 3's W4 run on the megakernels")
    params = engine.params
    del engine
    batched, bids, peaks = phase_serve_batched(
        torch, cfg, params, labels=("batched_w3", "batched_stacked_w3"))
    out_launches.update(batched)
    for label in bids:
        compare_ids(label, bids[label], slot_ids, "phase 3b's W4 run on K6")
        log(f"  [{label}] peak device memory {peaks[label]:.2f} GiB against "
            f"{w4['slot_peak']:.2f} GiB for phase 3b's W4 engine on K6")
    batched, _, _ = phase_serve_batched(torch, cfg, params, "int8", labels=("batched_int8_w3",))
    out_launches.update(batched)
    label = "paged_w3"
    disable, must, off = BATCH_PATHS[label]
    set_config(disable)
    engine = PagedBatchEngine(cfg, params, n_slots=BATCH_SLOTS, max_seq_len=2048,
                              page_size=PAGE)
    done, launches, _ = drive(torch, engine, batch_prompts(cfg), label, cfg)
    agree = sum(r.out_ids == ref for r, ref in zip(done, bids["batched_w3"]))
    log(f"  [{label}] greedy ids equal the W3 slot engine's on K6 for {agree}/{BATCH_REQUESTS} "
        "requests")
    if agree != BATCH_REQUESTS:
        raise AssertionError(f"[{label}] greedy ids differ from the W3 slot engine's on K6")
    check_path(label, launches, must, off)
    out_launches[label] = launches
    del engine, params
    torch.cuda.empty_cache()
    return out_launches


def int8_gated(prompts):
    """Indices of the requests whose prefill and history take the same
    numbers with the int8 cache and with prefill_a8 alone: prompts of up to
    32 tokens (K5 either way) and of at least _A8_MIN_M (K11 against K10,
    bit-equal); a prompt between them takes K11 against K1's GEMM. Each
    item is ``(tokens, fresh)``; a continued dialogue carries its history."""
    from awq_tpu_torch.ops import w4a16 as w4

    gated, chain = [], True
    for i, (n, fresh) in enumerate(prompts):
        chain = (chain or fresh) and (n <= 32 or n >= w4._A8_MIN_M)
        if chain:
            gated.append(i)
    return gated


def profile_prefill(torch, engine, n: int, label: str) -> None:
    """Kernels and device time of one ``n``-token prefill from position 0
    (torch.profiler), by kernel group; the cache is cleared after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from awq_tpu_torch.models.llama import forward

    engine.reset()
    toks = torch.randint(0, engine.cfg.vocab_size, (1, n),
                         generator=torch.Generator().manual_seed(5)).cuda()
    forward(engine.params, engine.cfg, toks, engine.cache, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        forward(engine.params, engine.cfg, toks, engine.cache, 0)
        torch.cuda.synchronize()
    us = {k: 0.0 for k in ("w4a8_gemm / w8a8_gemm", "quant_per_token", "w4a16_gemm",
                           "flash_prefill")}
    us["other"], n_kernels = 0.0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_kernels += 1
            key = next((k for k in us if k != "other"
                        and any(p in e.name for p in KERNEL_GROUPS[k])), "other")
            us[key] += e.time_range.elapsed_us()
    engine.reset()
    log(f"  [{label}] one {n}-token prefill: {n_kernels} kernels, device "
        f"{sum(us.values()) / 1e3:.3f} ms [" + ", ".join(
            f"{k} {v / 1e3:.3f}" for k, v in us.items() if v) + "] (torch.profiler)")


def phase_serve_int8_prefill(torch, cfg, params, ref):
    """Phase 3f, the int8-activation prefill at ``cfg``'s layers: phase 3's
    four requests through InferenceEngine with ``RuntimeConfig(prefill_w8=
    True)`` (K11 for the 200- and 1000-token prompts) and with
    ``cfg.prefill_a8`` alone (K10 for the 1000-token one, K1 for the 200),
    then phase 3b's twelve through an 8-slot BatchEngine each way and once
    through a PagedBatchEngine of 32 pages with the cache. Prints the cache's
    build time and GiB, TTFT beside phase 3's, the peak device memory and
    the kernels of one 1000-token prefill. The greedy ids of the two int8
    configurations must be equal where both take an int8 path (or K5) on
    the same history, and the paged engine's those of the slot engine with
    the cache; how many equal the W4A16 runs' is printed. ``ref`` holds
    phase 3's and 3b's ids, TTFTs and peaks. Returns {config: launches}."""
    import dataclasses

    from awq_tpu_torch.config import RuntimeConfig
    from awq_tpu_torch.runtime.batch_engine import BatchEngine
    from awq_tpu_torch.runtime.engine import InferenceEngine
    from awq_tpu_torch.runtime.paged import PagedBatchEngine

    cfg_a8 = dataclasses.replace(cfg, prefill_a8=True)
    rt_w8 = RuntimeConfig(max_seq_len=2048, prefill_w8=True)
    out_launches, ids = {}, {}
    for label, c, rt in (("prefill_w8", cfg, rt_w8),
                         ("prefill_a8", cfg_a8, RuntimeConfig(max_seq_len=2048))):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine = InferenceEngine(c, params, rt)
        torch.cuda.synchronize()
        caches = [v for k, v in engine.params["layers"].items() if k.endswith("_w8")]
        gib = sum(v.w8.numel() + v.scol.numel() * 4 for v in caches) / 2**30
        log(f"  [{label}] engine built in {time.perf_counter() - t0:.2f} s; int8 prefill "
            f"weight cache {gib:.4f} GiB over {len(caches)} linears x {cfg.num_layers} layers")
        torch.cuda.reset_peak_memory_stats()      # serving's peak, as phase 3's
        launches, got, ttft = serve_single(torch, engine, engine.cfg, (label,))
        out_launches.update(launches)
        ids[label] = got[label]
        log(f"  [{label}] peak device memory while serving "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB against "
            f"{ref['single_peak']:.2f} GiB for phase 3's engine")
        log(f"  [{label}] TTFT by prompt (ms), this run / phase 3 on W4A16: " + ", ".join(
            f"{n}: {a:.2f} / {b:.2f}" for (n, _), a, b in zip(REQUESTS, ttft[label],
                                                              ref["single_ttft"])))
        profile_prefill(torch, engine, 1000, label)
        del engine
    gated = int8_gated(REQUESTS)
    for i in gated:
        if ids["prefill_w8"][i] != ids["prefill_a8"][i]:
            raise AssertionError(f"request {i + 1}: greedy ids under prefill_w8 differ from "
                                 "those under prefill_a8 alone")
    log(f"  greedy ids under prefill_w8 equal those under prefill_a8 alone for requests "
        f"{[i + 1 for i in gated]} (both int8, or K5, on the same history)")
    for label in ids:
        compare_ids(label, ids[label], ref["single_ids"], "phase 3's W4A16 run")

    torch.cuda.empty_cache()
    prompts = batch_prompts(cfg)
    bids = {}
    for label, c, rt in (("batched_prefill_w8", cfg, rt_w8), ("batched_prefill_a8", cfg_a8, None),
                         ("paged_prefill_w8", cfg, rt_w8)):
        disable, must, off = BATCH_PATHS[label]
        set_config(disable)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kw = dict(n_slots=BATCH_SLOTS, max_seq_len=2048, runtime=rt)
        engine = (PagedBatchEngine(c, params, page_size=PAGE, **kw) if label.startswith("paged")
                  else BatchEngine(c, params, **kw))
        done, launches, _ = drive(torch, engine, prompts, label, cfg)
        log(f"  [{label}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"against {ref['slot_peak']:.2f} GiB for phase 3b's engine on K6")
        check_path(label, launches, must, off)
        out_launches[label] = launches
        bids[label] = [r.out_ids for r in done]
        del engine
    set_config(None)
    gated = int8_gated([(len(p), True) for p in prompts])
    for i in gated:
        if bids["batched_prefill_w8"][i] != bids["batched_prefill_a8"][i]:
            raise AssertionError(f"batched request {i + 1}: greedy ids under prefill_w8 differ "
                                 "from those under prefill_a8 alone")
    if bids["paged_prefill_w8"] != bids["batched_prefill_w8"]:
        raise AssertionError("[paged_prefill_w8] greedy ids differ from the slot engine's")
    log(f"  8 slots: greedy ids under prefill_w8 equal prefill_a8's for the {len(gated)} requests "
        f"with prompts of up to 32 or of 1000 tokens; the paged engine's equal the slot "
        f"engine's for {BATCH_REQUESTS}/{BATCH_REQUESTS}")
    for label in bids:
        compare_ids(label, bids[label], ref["slot_ids"], "phase 3b's W4A16 run on K6")
    torch.cuda.empty_cache()
    return out_launches


KERNEL_GROUPS = {"megakernel_attn_half": tuple(f"token_kernel<{t}, 1>" for t in (
                     "float", "__nv_bfloat16", "__half", "signed char", "char")),
                 "megakernel_mlp_half": ("token_kernel<__nv_bfloat16, 2>",),
                 "nccl all-reduce": ("nccl",),
                 "w4a16_gemv": ("w4a16_gemv",),
                 "flash_decode_layer": ("LayerKV",),
                 "flash_decode": ("flash_decode",),
                 "flash_verify": ("flash_verify_kernel",),
                 "w4a16_gemm": ("w4a16_wgmma_kernel", "splitk_reduce"),
                 "flash_prefill": ("flash_prefill",), "megakernel_token": ("token_kernel",),
                 "megakernel_chunk": ("chunk_kernel",),
                 "megakernel_batched": ("batched_kernel",),
                 "cache_append": ("cache_append_kernel",),
                 "w4a8_gemm / w8a8_gemm": ("w4a8_wgmma_kernel", "w8a8_wgmma_kernel",
                                           "w8a8_splitk_epilogue"),
                 "quant_per_token": ("quant_per_token_kernel",)}


def profile_steps(torch, run_step, ms_ref: float, label: str, where: str, unit: str,
                  steps: int = 8) -> None:
    """A torch.profiler trace of ``steps`` calls of ``run_step(i)``: the host's
    time per step and its top operations, the device time per step by kernel,
    the kernels per step, and the device's idle share against ``ms_ref``, the
    unprofiled time of such a step. Returns the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            run_step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    ops = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    op_ms = sum(e.self_cpu_time_total for e in ops) / steps / 1e3
    top = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:6]
    log(f"  [{label}] host under the profiler: {wall_ms:.3f} ms/step, of which PyTorch ops "
        f"{op_ms:.3f} ms (top: " + ", ".join(
            f"{e.key} x{e.count // steps} {e.self_cpu_time_total / steps / 1e3:.2f}"
            for e in top) + "); the rest is Python and the ctypes launches")
    us = {k: 0.0 for k in KERNEL_GROUPS}
    us["other PyTorch kernels"] = 0.0
    n_kernels = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n_kernels += 1
        key = next((k for k, pats in KERNEL_GROUPS.items()
                    if any(p in e.name for p in pats)), "other PyTorch kernels")
        us[key] += e.time_range.elapsed_us()
    if not n_kernels:
        log(f"  [{label}] profiler: no device events recorded; no breakdown")
        return prof
    busy_ms = sum(us.values()) / steps / 1e3
    parts = ", ".join(f"{k} {v / steps / 1e3:.3f}" for k, v in us.items() if v)
    log(f"  [{label}] decode step device time (torch.profiler, {steps} steps at "
        f"{where}): {busy_ms:.3f} ms/step busy [{parts}], "
        f"{n_kernels / steps:.0f} kernels/step; against {ms_ref:.3f} "
        f"{unit} unprofiled the device is idle {1 - busy_ms / ms_ref:.1%}")
    return prof


BATCH_PROMPTS = (16, 24, 200, 1000)     # in rotation over the twelve requests
BATCH_SLOTS, BATCH_REQUESTS, BATCH_NEW = 8, 12, 32


def batch_prompts(cfg):
    import torch

    rng = torch.Generator().manual_seed(11)
    return [torch.randint(0, cfg.vocab_size, (BATCH_PROMPTS[i % 4],),
                          generator=rng).tolist() for i in range(BATCH_REQUESTS)]


def drive(torch, engine, prompts, label, cfg, gen=None):
    """The twelve requests through ``engine``: six at once, then one more
    every fourth step while a slot is free, so each joins while the others
    decode; greedy, or ``gen``'s sampling. Warms the engine first and resets
    the launch counts just before the run. Returns the finished requests in
    submission order, the launch counts and the median decode-only ms/step."""
    from awq_tpu_torch.config import GenConfig

    gen = gen or GenConfig(greedy=True, max_new_tokens=BATCH_NEW)
    # warm: first launches load the kernels' modules
    engine.submit(prompts[0][:8], GenConfig(greedy=True, max_new_tokens=2))
    engine.submit(prompts[2][:40], GenConfig(greedy=True, max_new_tokens=2))
    engine.run()
    engine.finished.clear()
    torch.cuda.synchronize()
    reset_counters()
    rids, decode_ms, admit_ms = [], [], []
    pending = list(prompts)
    n_steps = 0
    t_run = time.perf_counter()
    while pending or engine.waiting or engine.n_active:
        free = BATCH_SLOTS - engine.n_active - len(engine.waiting)
        want = 6 - len(rids) if len(rids) < 6 else int(n_steps % 4 == 0)
        for _ in range(min(want, free, len(pending))):
            rids.append(engine.submit(pending.pop(0), gen))
        admitting = bool(engine.waiting)
        t0 = time.perf_counter()
        engine.step()               # ends with the fetch of the sampled ids
        (admit_ms if admitting else decode_ms).append((time.perf_counter() - t0) * 1e3)
        n_steps += 1
    wall = time.perf_counter() - t_run
    launches = read_counters()
    done = [engine.finished[r] for r in rids]
    for r in done:
        if len(r.out_ids) != BATCH_NEW or min(r.out_ids) < 0 \
                or max(r.out_ids) >= cfg.vocab_size:
            raise AssertionError(f"[{label}] request {r.rid}: bad output ids {r.out_ids}")
    n_tok = sum(len(r.out_ids) for r in done)
    ttft = {n: [] for n in BATCH_PROMPTS}
    for r, prompt in zip(done, prompts):
        ttft[len(prompt)].append((r.first_token_at - r.submitted_at) * 1e3)
    ms_step = statistics.median(decode_ms)
    log(f"  [{label}] {BATCH_REQUESTS} requests x {BATCH_NEW} new tokens through "
        f"{BATCH_SLOTS} slots: {n_steps} steps in {wall * 1e3:.1f} ms, "
        f"{n_tok / wall:.1f} tokens/s aggregate; decode-only steps "
        f"{ms_step:.3f} ms/step median ({min(decode_ms):.3f}-{max(decode_ms):.3f}, "
        f"{len(decode_ms)} steps), steps that admit {statistics.median(admit_ms):.2f} ms median")
    log(f"  [{label}] TTFT (submit to first token, ms) by prompt length: " + ", ".join(
        f"{n}: " + "/".join(f"{t:.2f}" for t in ts) for n, ts in ttft.items()))
    log(f"  [{label}] launches during the twelve requests: {launches}")
    return done, launches, ms_step


def check_path(label, launches, must, off):
    if not label.startswith(("falcon", "starcoder")) and launches.get("flash_decode_layer"):
        raise AssertionError(f"[{label}] K14 (flash_decode_layer) ran off the falcon and "
                             "StarCoder paths")
    for k in must:
        if launches[k] <= 0:
            raise AssertionError(f"[{label}] kernel {k} was not launched on its path")
    for k in off:
        if launches[k]:
            raise AssertionError(f"[{label}] kernel {k} ran off its path")


# label: (AWQ_TPU_DISABLE_MEGAKERNEL, kernels that must run, kernels that must
# not) for phases 3b and 3d (8 slots); the int8 cache's prompts all take the
# stacked prefill into the staging cache (K5 takes no int8 cache)
BATCH_PATHS = {
    "batched": (None, ("megakernel_batched", "megakernel_chunk", "w4a16_gemm",
                       "flash_prefill"), ("cache_append", "flash_decode")),
    "batched_stacked": ("1", ("w4a16_gemv", "w4a16_gemm", "flash_decode", "flash_prefill",
                              "cache_append"),
                        ("megakernel_batched", "megakernel_chunk", "megakernel_token")),
    "batched_int8": (None, ("megakernel_batched_int8", "w4a16_gemm", "flash_prefill"),
                     ("megakernel_batched", "megakernel_chunk", "flash_decode_int8",
                      "cache_append_int8")),
    "batched_stacked_int8": ("1", ("w4a16_gemv", "w4a16_gemm", "flash_decode_int8",
                                   "flash_prefill", "cache_append_int8"),
                             ("megakernel_batched", "megakernel_batched_int8",
                              "megakernel_chunk", "megakernel_token", "megakernel_token_int8",
                              "flash_decode", "cache_append")),
    "batched_w3": (None, ("megakernel_batched_w3", "megakernel_chunk_w3", "w3a16_gemm",
                          "flash_prefill"),
                   ("megakernel_batched", "megakernel_chunk", "w4a16_gemm", "cache_append",
                    "flash_decode")),
    "batched_stacked_w3": ("1", ("w3a16_gemv", "w3a16_gemm", "flash_decode", "flash_prefill",
                                 "cache_append"),
                           ("megakernel_batched_w3", "megakernel_chunk_w3",
                            "megakernel_token_w3", "w4a16_gemv", "w4a16_gemm")),
    # K6's int8 and paged W3 modes, on K6 only
    "batched_int8_w3": (None, ("megakernel_batched_int8_w3", "w3a16_gemm", "flash_prefill"),
                        ("megakernel_batched_w3", "megakernel_batched_int8",
                         "megakernel_chunk_w3", "flash_decode_int8", "cache_append_int8")),
    "paged_w3": (None, ("megakernel_batched_paged_w3", "megakernel_chunk_w3", "w3a16_gemm",
                        "flash_prefill"),
                 ("megakernel_batched_paged", "megakernel_batched_w3", "flash_decode_paged",
                  "cache_append_paged")),
    # phase 3f: admissions over 32 tokens on K11 with the cache, on K10
    # (1000 tokens) and K1 (200) with prefill_a8 alone
    "batched_prefill_w8": (None, ("megakernel_batched", "megakernel_chunk", "w8a8_gemm",
                                  "quant_per_token", "flash_prefill"),
                           ("w4a8_gemm", "w4a16_gemm", "cache_append")),
    "batched_prefill_a8": (None, ("megakernel_batched", "megakernel_chunk", "w4a8_gemm",
                                  "w4a16_gemm", "quant_per_token"), ("w8a8_gemm",)),
    "paged_prefill_w8": (None, ("megakernel_batched_paged", "megakernel_chunk", "w8a8_gemm",
                                "quant_per_token"),
                         ("w4a8_gemm", "w4a16_gemm", "megakernel_batched")),
    # phase 3m: BatchEngine(spec_k=7), every step a verify (the stacked path
    # at W = 8: K1's GEMM over 64 rows, the window mode of K2 or K9 a layer,
    # which appends the windows: no K7 or fused append, no K6)
    **{label: (None, (ver, "w4a16_gemm", "flash_prefill"),
               ("cache_append", "cache_append_int8", "flash_decode", "flash_decode_int8",
                "megakernel_batched", "megakernel_batched_int8", other))
       for label, ver, other in (("spec", "flash_verify", "flash_verify_int8"),
                                 ("spec_sampled", "flash_verify", "flash_verify_int8"),
                                 ("spec_int8", "flash_verify_int8", "flash_verify"))},
}


def phase_serve_batched(torch, cfg, params, cache_dtype=None, labels=None):
    """Phase 3b (and 3d with ``cache_dtype="int8"``): twelve requests through
    an 8-slot BatchEngine, on K6 and on the stacked path (or the BATCH_PATHS
    ``labels``); returns {config: launches}, {config: greedy ids} and
    {config: peak device memory, GiB}."""
    from awq_tpu_torch.runtime.batch_engine import BatchEngine

    prompts = batch_prompts(cfg)
    out_launches, ids, peaks = {}, {}, {}
    sfx = "" if cache_dtype is None else f"_{cache_dtype}"
    for label in labels or ("batched" + sfx, "batched_stacked" + sfx):
        disable, must, off = BATCH_PATHS[label]
        set_config(disable)
        log(f"  [{label}] AWQ_TPU_DISABLE_MEGAKERNEL={disable or 'unset'}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine = BatchEngine(cfg, params, n_slots=BATCH_SLOTS, max_seq_len=2048,
                             **({} if cache_dtype is None else {"cache_dtype": cache_dtype}))
        log(f"  [{label}] the {BATCH_SLOTS}-slot cache: "
            f"{cache_bytes(engine.cache) / 2**30:.4f} GiB")
        done, launches, ms_step = drive(torch, engine, prompts, label, cfg)
        peaks[label] = torch.cuda.max_memory_allocated() / 2**30
        log(f"  [{label}] peak device memory {peaks[label]:.2f} GiB")
        ids[label] = [r.out_ids for r in done]
        check_path(label, launches, must, off)
        out_launches[label] = launches
        # eight more steps over all slots at the lengths the run left behind
        where = f"slot lengths {sorted(int(x) for x in engine.lengths)}"

        def one_step(i):
            engine._decode().argmax(-1).cpu()
            engine.lengths += 1

        one_step(0)
        profile_steps(torch, one_step, ms_step, label, where, "ms/step")
        if disable is None:
            time_prefix_copy(torch, engine)
        del engine
        torch.cuda.empty_cache()
    set_config(None)
    if len(ids) == 2:
        a, b = ids.values()
        log(f"  greedy ids of the two paths agree on {sum(x == y for x, y in zip(a, b))}/"
            f"{BATCH_REQUESTS} requests (random weights: a rounding difference can flip an "
            "argmax and the rest follows)")
    return out_launches, ids, peaks


SPEC_K = VERIFY_W - 1           # phase 3m's drafts a window
SPEC_GRAM, SPEC_REPEATS = 16, (3, 4, 8, 16)     # phase 3m (a): prompts of a repeated 16-gram
NEAR_TIE = 1e-2                  # where ids part: the reference's top-two gap / its largest


def near_tie_gap(torch, cfg, params, ctx, cache_dtype) -> float:
    """The top-two gap of the logits after ``ctx``, over their largest
    magnitude: ``forward`` of the whole context on a fresh one-row cache of
    ``cache_dtype`` (the reference's logits at the step where two runs'
    ids part, up to the kernels' rounding)."""
    from awq_tpu_torch.models.llama import forward, init_cache

    cache = init_cache(cfg, 1, len(ctx), cache_dtype or torch.bfloat16, device="cuda")
    logits = forward(params, cfg, torch.tensor([ctx], device="cuda"), cache, 0)[0][0, -1].float()
    top = logits.topk(2).values
    return float((top[0] - top[1]) / logits.abs().max())


def check_near_ties(torch, cfg, params, label, prompts, got, ref, what, cache_dtype=None):
    """Greedy ids of two runs: equal, or where a request's ids part the
    reference's top-two logit gap at that step is a near-tie (at most
    NEAR_TIE of its largest logit, ``tests/test_torch_tp_engine_greedy.py``'s
    rule); anything else fails."""
    parted = []
    for i, (prompt, a, b) in enumerate(zip(prompts, got, ref)):
        j = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y),
                 None if len(a) == len(b) else min(len(a), len(b)))
        if j is None:
            continue
        gap = near_tie_gap(torch, cfg, params, list(prompt) + list(b[:j]), cache_dtype)
        parted.append((i + 1, j, gap))
        if gap > NEAR_TIE:
            raise AssertionError(f"[{label}] request {i + 1}: ids part from {what} at step {j} "
                                 f"where the reference's top-two gap is {gap:.3e} of its "
                                 f"largest logit (> {NEAR_TIE:g}: no near-tie)")
    log(f"  [{label}] greedy ids equal {what} for {len(ref) - len(parted)}/{len(ref)} "
        "requests" + ("" if not parted else "; where they part (request, step, the "
                      "reference's top-two gap / its largest logit): "
                      + ", ".join(f"({r}, {j}, {g:.2e})" for r, j, g in parted)
                      + f", each a near-tie (<= {NEAR_TIE:g})"))


def phase_serve_spec(torch, cfg, params, slot_ids, int8_slot_ids):
    """Phase 3m, speculative decoding (ROADMAP A11) over phase 3's model:

    (a) four requests whose prompts repeat a random 16-gram (3, 4, 8 and 16
    times), each a fresh dialogue, through ``InferenceEngine.
    generate_speculative(k=7)`` (greedy: the host loop, the drafts found on
    the host and a window of 8 a step through ``forward``, one launch of K5;
    and with ``device_loop=True``, a fixed window of 8 a step through
    ``forward`` too) and through the same engine's
    ``generate`` (K4 on the graph): ids equal, or parting at a near-tie; ms
    per verify step against ms per decode step; drafted and accepted; the
    host loop's verify step in parts (the drafter, K5 and the head with the
    read, the step) and a profile of it (kernels, idle share);
    (b) phase 3b's twelve requests through an 8-slot ``BatchEngine(spec_k=7)``
    over a bf16 cache and an int8 cache (every step a ``verify_step_batched``,
    the window mode of K2 or K9 once a layer, no append launch) against the
    ``spec_k=0`` engines' ids of phases 3b and 3d (K6), and a sampled run over
    bf16; the verify step's and the decode step's host-clock times at the
    run's lengths, tokens/s, and a profile of verify steps (kernels, idle
    share). Returns {label: launches}."""
    import numpy as np

    from awq_tpu_torch.config import GenConfig, RuntimeConfig
    from awq_tpu_torch.models.llama import forward, verify_step_batched
    from awq_tpu_torch.runtime.batch_engine import BatchEngine
    from awq_tpu_torch.runtime.engine import InferenceEngine

    out_launches = {}
    torch.cuda.empty_cache()
    engine = InferenceEngine(cfg, params, RuntimeConfig(max_seq_len=2048))
    rng = torch.Generator().manual_seed(13)
    gram = torch.randint(0, cfg.vocab_size, (SPEC_GRAM,), generator=rng).tolist()
    prompts = [gram * r for r in SPEC_REPEATS]
    greedy = GenConfig(greedy=True, max_new_tokens=BATCH_NEW)
    engine.warmup()
    # None: generate; False: the host loop (the default); True: device_loop
    modes = (None, False, True)
    runs = {}
    for label, mode in [("warm", m) for m in modes] + [("run", m) for m in modes]:
        reset_counters()
        rows = []
        for prompt in prompts:
            engine.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode is None:
                out = engine.generate(prompt, greedy)
                ids = out["output_ids"].tolist()
            else:
                out = engine.generate_speculative(prompt, BATCH_NEW, k=SPEC_K,
                                                  **({"device_loop": True} if mode else {}))
                ids = list(out["output_ids"])
            torch.cuda.synchronize()
            rows.append((ids, out, (time.perf_counter() - t0) * 1e3))
        if label == "run":
            runs[mode] = rows, read_counters()
    refs = runs[None][0]
    for mode, name, must, off in (
            (False, "spec single", ("megakernel_chunk",),
             ("flash_verify", "flash_verify_int8", "flash_decode")),
            (True, "spec single device_loop", ("megakernel_chunk",),
             ("flash_verify", "flash_verify_int8", "flash_decode"))):
        gots, calls = runs[mode]
        out_launches["spec_single" + ("_device" if mode else "")] = calls
        log(f"  [{name}] wrapper calls over the four speculative requests: {nonzero(calls)}")
        check_path(name, calls, must, off)
        check_near_ties(torch, cfg, engine.params, name, prompts, [g[0] for g in gots],
                        [r[0] for r in refs], "the same engine's generate")
        for i, ((ids, out, ms), (_, ref, ref_ms)) in enumerate(zip(gots, refs)):
            st = out["stats"]
            ttft = ref["timing"]["ttft_s"] * 1e3
            verify_ms = (ms - ttft) / max(st["steps"] - 1, 1)
            log(f"  [{name}] request {i + 1}: prompt {len(prompts[i])}: {st['steps']} steps "
                f"(the prefill and {st['steps'] - 1} verify steps), drafted {st['drafted']}, "
                f"accepted {st['accepted']}; {ms:.1f} ms for {len(ids)} tokens "
                f"({len(ids) / ms * 1e3:.1f} tokens/s) against generate's {ref_ms:.1f} ms "
                f"({len(ids) / ref_ms * 1e3:.1f} tokens/s); a verify step {verify_ms:.3f} ms "
                f"(the round less generate's TTFT {ttft:.2f} ms) against a decode step "
                f"{ref['timing']['ms_per_token']:.3f} ms (K4 on the graph): "
                f"{verify_ms / ref['timing']['ms_per_token']:.2f}x")
    # the host loop's verify step in parts, after a 1000-position history: the
    # drafter (numpy, over the longest prompt, where it finds 7 drafts), K5 and
    # the head over one window of 8 with the argmax read back, and the whole step
    from awq_tpu_torch.runtime.speculative import ngram_propose

    engine.reset()
    hist = torch.randint(0, cfg.vocab_size, (1, 1000), generator=rng).to("cuda")
    engine._forward(hist, 0)
    ctx = np.asarray(prompts[-1], np.int32)
    draft_ms = host_ms(torch, lambda: ngram_propose(ctx, SPEC_K), reps=20)
    win = torch.randint(0, cfg.vocab_size, (1, VERIFY_W), generator=rng).to("cuda")
    k5_ms = host_ms(torch, lambda: forward(engine.params, engine.cfg, win, engine.cache, 1000,
                                           last_only=False)[0].argmax(-1).cpu(), reps=10)

    def host_step(i):
        d = ngram_propose(ctx, SPEC_K)
        w = torch.from_numpy(np.concatenate([ctx[-1:], d]).astype(np.int64)[None]).to("cuda")
        forward(engine.params, engine.cfg, w, engine.cache, 1000,
                last_only=False)[0][0].argmax(-1).tolist()

    step_ms = host_ms(torch, lambda: host_step(0), reps=10)
    log(f"  [spec single] the host loop's verify step at position 1000, host clock: the "
        f"drafter {draft_ms:.3f} ms (ngram_propose over {len(ctx)} ids, found "
        f"{len(ngram_propose(ctx, SPEC_K))}), K5 and the head over {VERIFY_W} rows with the "
        f"argmax read {k5_ms:.3f} ms, the whole step {step_ms:.3f} ms")
    profile_steps(torch, host_step, step_ms, "spec single verify", "position 1000", "ms/step")
    del engine
    torch.cuda.empty_cache()

    bprompts = batch_prompts(cfg)
    sampled = GenConfig(greedy=False, temperature=0.7, top_k=40, top_p=0.9,
                        max_new_tokens=BATCH_NEW)
    for label, cache_dtype, gen, ref in (("spec", None, None, slot_ids),
                                         ("spec_int8", "int8", None, int8_slot_ids),
                                         ("spec_sampled", None, sampled, None)):
        disable, must, off = BATCH_PATHS[label]
        set_config(disable)
        torch.cuda.empty_cache()
        engine = BatchEngine(cfg, params, n_slots=BATCH_SLOTS, max_seq_len=2048,
                             spec_k=SPEC_K,
                             **({} if cache_dtype is None else {"cache_dtype": cache_dtype}))
        done, launches, ms_step = drive(torch, engine, bprompts, label, cfg, gen=gen)
        check_path(label, launches, must, off)
        out_launches[label] = launches
        if ref is not None:
            check_near_ties(torch, cfg, params, label, bprompts, [r.out_ids for r in done], ref,
                            "the spec_k=0 engine's on K6", cache_dtype)
        # a verify step and a decode step (K6) over the 8 slots at the lengths
        # the run left behind, by the host clock, and one verify step's launches
        mx = int(engine.lengths.max())
        lens = torch.from_numpy(engine.lengths).to("cuda")
        windows = torch.randint(0, cfg.vocab_size, (BATCH_SLOTS, VERIFY_W), generator=rng
                                ).to("cuda")

        def verify_once(i):
            verify_step_batched(engine.params, engine.cfg, windows, engine.cache, lens,
                                max_length=mx)[0].argmax(-1).cpu()

        verify_once(0)
        reset_counters()
        verify_once(0)
        one = nonzero(read_counters())
        ver = "flash_verify_int8" if cache_dtype else "flash_verify"
        if one.get(ver) != cfg.num_layers or any(k.startswith("cache_append") for k in one):
            raise AssertionError(f"[{label}] one verify step launched {one}: not the window "
                                 f"mode once a layer ({cfg.num_layers}) with no append")
        v_ms = host_ms(torch, lambda: verify_once(0), reps=8)
        d_ms = host_ms(torch, lambda: engine._decode().argmax(-1).cpu(), reps=8)
        log(f"  [{label}] one verify step of {BATCH_SLOTS} x {VERIFY_W} at slot lengths up to "
            f"{mx}: {v_ms:.3f} ms against a decode step (K6) {d_ms:.3f} ms "
            f"({v_ms / d_ms:.2f}x), host clock; its launches: {one}")
        profile_steps(torch, verify_once, v_ms, label + " verify",
                      f"slot lengths up to {mx}", "ms/step")
        del engine
        torch.cuda.empty_cache()
    set_config(None)
    return out_launches


PAGE, SMALL_POOL = 256, 12     # phase 3c: page size; pages of the preempting pool
FAMILY_LAYERS = 32             # phase 3k: Falcon-7B's and MPT-7B's depth
# phase 3l's 8-slot runs: the first 8 layers of each model (at full depth, 32 / 40
# / 32 layers, the smoke passed 900 s of its 1200 s limit on the H100)
NEW_FAMILY_BATCH_LAYERS = 8


def phase_serve_paged(torch, cfg, params, slot_ids):
    """Phase 3c: phase 3b's twelve requests through an 8-slot
    PagedBatchEngine with pages of 256, on K6 and on the stacked path, with
    the default pool (greedy ids must equal phase 3b's on K6) and with a
    pool of SMALL_POOL pages (at least one preemption; every request
    completes). Returns {config: launches}."""
    from awq_tpu_torch.config import GenConfig
    from awq_tpu_torch.runtime.paged import PagedBatchEngine

    prompts = batch_prompts(cfg)
    kv_pos = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2
    log(f"  the 8-slot engine's cache: {BATCH_SLOTS * 2048 * kv_pos / 2**30:.3f} GiB")
    out_launches = {}
    for pool_label, n_pages in (("default pool", None), ("small pool", SMALL_POOL)):
        for label, disable in (("paged", None), ("paged_stacked", "1")):
            set_config(disable)
            tag = label + ("" if n_pages is None else "_small")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            engine = PagedBatchEngine(cfg, params, n_slots=BATCH_SLOTS, max_seq_len=2048,
                                      page_size=PAGE, n_pages=n_pages)
            pool_bytes = engine.cache.numel() * engine.cache.element_size()
            log(f"  [{tag}] {pool_label}: {engine.n_pages} pages of {PAGE} "
                f"({pool_bytes / 2**30:.3f} GiB); AWQ_TPU_DISABLE_MEGAKERNEL={disable or 'unset'}")
            done, launches, ms_step = drive(torch, engine, prompts, tag, cfg)
            agree = sum(r.out_ids == ref for r, ref in zip(done, slot_ids))
            log(f"  [{tag}] {engine.n_preempted} preemptions; greedy ids equal phase 3b's "
                f"on K6 for {agree}/{BATCH_REQUESTS} requests; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if disable is None:
                check_path(tag, launches,
                           ("megakernel_batched_paged", "megakernel_chunk", "w4a16_gemm",
                            "flash_prefill"),
                           ("megakernel_batched", "flash_decode", "flash_decode_paged",
                            "cache_append", "cache_append_paged"))
            else:
                check_path(tag, launches,
                           ("w4a16_gemv", "w4a16_gemm", "flash_decode_paged", "flash_prefill",
                            "cache_append_paged"),
                           ("megakernel_batched", "megakernel_batched_paged",
                            "megakernel_chunk", "megakernel_token", "flash_decode",
                            "cache_append"))
            if n_pages is None and disable is None and agree != BATCH_REQUESTS:
                raise AssertionError(f"[{tag}] greedy ids differ from phase 3b's on K6")
            if n_pages is not None and not engine.n_preempted:
                raise AssertionError(f"[{tag}] the small pool preempted nothing")
            out_launches[tag] = launches
            if n_pages is None:
                # eight live requests, then a profile of eight engine steps
                gen = GenConfig(greedy=True, max_new_tokens=12)
                for i in range(BATCH_SLOTS):
                    engine.submit(prompts[i], gen)
                engine.step()
                where = f"slot lengths {sorted(int(x) for x in engine.lengths)}"
                profile_steps(torch, lambda i: engine.step(), ms_step, tag, where, "ms/step")
                engine.run()
            del engine
    set_config(None)
    torch.cuda.empty_cache()
    return out_launches


# phase 3k: (label, kernels that must run, kernels that must not) of the
# families' batched, int8 and paged engines; every prompt takes the stacked
# prefill (K5 and K6 take the llama shape only), no K14 and no megakernel
_FAMILY_OFF = ("flash_decode_layer", "flash_decode_layer_alibi", "megakernel_batched",
               "megakernel_batched_paged", "megakernel_batched_int8", "megakernel_token",
               "megakernel_token_mpt", "megakernel_chunk", "flash_decode", "flash_decode_paged",
               "flash_decode_int8")
FAMILY_PATHS = {
    "falcon": {"batched": (("flash_decode_wide", "flash_prefill", "cache_append"),
                           ("flash_decode_paged_wide", "flash_decode_int8_wide",
                            "cache_append_int8")),
               "batched_int8": (("flash_decode_int8_wide", "flash_prefill",
                                 "cache_append_int8"),
                                ("flash_decode_wide", "cache_append")),
               "paged": (("flash_decode_paged_wide", "flash_prefill", "cache_append_paged"),
                         ("flash_decode_wide", "cache_append"))},
    "mpt": {"batched": (("flash_decode_alibi", "flash_prefill_alibi", "cache_append"),
                        ("flash_decode_paged_alibi", "flash_decode_int8_alibi", "flash_prefill",
                         "cache_append_int8")),
            "batched_int8": (("flash_decode_int8_alibi", "flash_prefill_alibi",
                              "cache_append_int8"),
                             ("flash_decode_alibi", "flash_prefill", "cache_append")),
            "paged": (("flash_decode_paged_alibi", "flash_prefill_alibi", "cache_append_paged"),
                      ("flash_decode_alibi", "flash_prefill", "cache_append"))},
}
# the address functor of the split decode's instance each engine's step
# launches, as the device trace names it (flash_decode_kernel<D, NPW, CUR, KV>)
FAMILY_FUNCTOR = {"batched": "ContigKV", "batched_int8": "Int8KV", "paged": "PagedKV"}


def decode_instances(prof, steps: int) -> dict:
    """The split decode's instances in a device trace: {short name: launches
    per step}, the name cut to the kernel's template arguments."""
    from torch.autograd import DeviceType

    seen = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "flash_decode_kernel<" in e.name:
            name = e.name[e.name.index("flash_decode_kernel<"):].split(">(")[0] + ">"
            name = name.replace("(anonymous namespace)::", "")
            seen[name] = seen.get(name, 0) + 1
    return {k: v / steps for k, v in seen.items()}


def phase_serve_families_batched(torch, layers: int):
    """Phase 3k: Falcon-7B (W4-g64, its head quantized) and MPT-7B (W4-g128
    ``zero_mean``, the tied embedding quantized as the head) at ``layers``
    layers and full width, phase 3b's twelve requests through an 8-slot
    ``BatchEngine`` over a bf16 and over an int8 cache, then through an
    8-slot ``PagedBatchEngine`` with pages of 256 and the default pool
    (its greedy ids must equal the bf16 slot engine's bit for bit). Every
    step is the stacked path: K1's GEMV at 8 rows, K2, K9 or K8 in their
    head_dim-64 wide-group modes (falcon) or with ALiBi slopes (MPT), one
    append fused into them; no K14, K6 or K4. Each run: ms/step, tokens/s, TTFT, peak
    memory, and a profile of eight steps (kernels per step, idle share, the
    split decode's instances by the device trace). Returns {label:
    launches}."""
    from awq_tpu_torch.config import GenConfig, ModelConfig, QuantConfig
    from awq_tpu_torch.models.llama import init_qparams
    from awq_tpu_torch.runtime.batch_engine import BatchEngine
    from awq_tpu_torch.runtime.paged import PagedBatchEngine

    out = {}
    set_config(None)
    for fam, base, group in (("falcon", FALCON_7B, FALCON_G), ("mpt", MPT_7B, G)):
        cfg = ModelConfig(**{**base, "num_layers": layers})
        prompts = batch_prompts(cfg)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = init_qparams(cfg, QuantConfig(w_bit=4, group_size=group),
                              torch.Generator(device="cuda").manual_seed(0))
        if fam == "mpt":
            params = zero_mean(params, 4)
            params["lm_head"] = params["embed"].T.contiguous()
        ids, quantize_head = {}, True
        for kind in ("batched", "batched_int8", "paged"):
            label = f"{fam}_{kind}"
            must, off = FAMILY_PATHS[fam][kind]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            if kind == "paged":
                engine = PagedBatchEngine(cfg, params, n_slots=BATCH_SLOTS, max_seq_len=2048,
                                          page_size=PAGE)
                kv_bytes = engine.cache.numel() * engine.cache.element_size()
            else:
                engine = BatchEngine(cfg, params, n_slots=BATCH_SLOTS, max_seq_len=2048,
                                     quantize_head=quantize_head,
                                     **({"cache_dtype": "int8"} if kind == "batched_int8"
                                        else {}))
                kv_bytes = cache_bytes(engine.cache)
            if quantize_head:       # the engines after the first share its fused tree
                params, quantize_head = engine.params, False
                torch.cuda.synchronize()
                log(f"  [{fam}] model: {layers} layers, W4-g{group} weights + W4 head "
                    f"{weight_bytes(params) / 1e9:.3f} GB, built in "
                    f"{time.perf_counter() - t0:.1f} s")
            log(f"  [{label}] the {BATCH_SLOTS}-slot cache"
                + (f" ({engine.n_pages} pages of {PAGE})" if kind == "paged" else "")
                + f": {kv_bytes / 2**30:.4f} GiB")
            done, launches, ms_step = drive(torch, engine, prompts, label, cfg)
            peak = torch.cuda.max_memory_allocated() / 2**30
            ids[kind] = [r.out_ids for r in done]
            check_path(label, launches, ("w4a16_gemv", "w4a16_gemm") + must, _FAMILY_OFF + off)
            log(f"  [{label}] peak device memory {peak:.2f} GiB")
            if kind == "paged":
                gen = GenConfig(greedy=True, max_new_tokens=12)
                for i in range(BATCH_SLOTS):
                    engine.submit(prompts[i], gen)
                engine.step()

                def one_step(i):
                    engine.step()
            else:
                def one_step(i):
                    engine._decode().argmax(-1).cpu()
                    engine.lengths += 1

                one_step(0)
            where = f"slot lengths {sorted(int(x) for x in engine.lengths)}"
            prof = profile_steps(torch, one_step, ms_step, label, where, "ms/step")
            inst = decode_instances(prof, 8)
            log(f"  [{label}] the split decode's instances by the device trace, per step: "
                + (", ".join(f"{k} x{v:g}" for k, v in inst.items()) or "none recorded"))
            if any("LayerKV" in k for k in inst):
                raise AssertionError(f"[{label}] K14 (LayerKV) in the batched step's trace")
            if inst and not any(FAMILY_FUNCTOR[kind] in k for k in inst):
                raise AssertionError(f"[{label}] no {FAMILY_FUNCTOR[kind]} instance in the "
                                     "batched step's trace")
            if kind == "paged":
                engine.run()
            out[label] = launches
            del engine
        if ids["paged"] != ids["batched"]:
            compare_ids(f"{fam}_paged", ids["paged"], ids["batched"], "the slot engine's")
            raise AssertionError(f"[{fam}_paged] greedy ids differ from the slot engine's")
        log(f"  [{fam}_paged] greedy ids equal the bf16 slot engine's for all "
            f"{BATCH_REQUESTS} requests, bit for bit")
        compare_ids(f"{fam}_batched_int8", ids["batched_int8"], ids["batched"],
                    "the bf16 cache's (information: int8 changes the numbers)")
        del params
        torch.cuda.empty_cache()
    return out


# phase 3l's 8-slot runs: (kernels that must run, kernels that must not) by
# family and engine; every step the stacked path (K2 at OPT-6.7B's and
# Pythia-6.9B's MHA heads, the wide unit's K2, K9 and K8 at StarCoder's
# group), no K14, K6 or K4
_NEW_OFF = ("flash_decode_layer", "megakernel_batched", "megakernel_batched_paged",
            "megakernel_batched_int8", "megakernel_token", "megakernel_chunk",
            "flash_decode_alibi", "flash_prefill_alibi", "flash_decode_layer_alibi")
NEW_FAMILY_PATHS = {
    "opt": {"batched": (("flash_decode", "flash_prefill", "cache_append"),
                        ("flash_decode_wide", "flash_decode_paged", "flash_decode_int8"))},
    "pythia": {"batched": (("flash_decode", "flash_prefill", "cache_append"),
                           ("flash_decode_wide", "flash_decode_paged", "flash_decode_int8"))},
    "starcoder": {"batched": (("flash_decode_wide", "flash_prefill", "cache_append"),
                              ("flash_decode", "flash_decode_paged_wide",
                               "flash_decode_int8_wide", "cache_append_int8")),
                  "batched_int8": (("flash_decode_int8_wide", "flash_prefill",
                                    "cache_append_int8"),
                                   ("flash_decode_wide", "flash_decode_int8", "cache_append")),
                  "paged": (("flash_decode_paged_wide", "flash_prefill", "cache_append_paged"),
                            ("flash_decode_wide", "flash_decode_paged", "cache_append"))},
}


def cut_layers(params, n: int):
    """The first ``n`` decoder layers of a stacked parameter tree (views)."""
    from awq_tpu_torch.ops.w4a16 import QLinear

    def cut(x):
        if isinstance(x, QLinear):
            return QLinear(qweight=x.qweight[:n], scales=x.scales[:n], szeros=x.szeros[:n],
                           bias=None if x.bias is None else x.bias[:n], w_bit=x.w_bit,
                           group_size=x.group_size, dense3=x.dense3)
        return x[:n]

    return {**params, "layers": {k: cut(v) for k, v in params["layers"].items()}}


def phase_serve_new_families(torch, batch_layers=None):
    """Phase 3l: OPT-6.7B, StarCoder and Pythia-6.9B at their published
    widths and depths, random W4-g128 weights from seed 0 (``init_qparams``,
    ``zero_mean``; the tied embedding of OPT and StarCoder as the head),
    the head quantized (``quantize_head``), a bf16 cache of 2048 positions:
    phase 3's four requests through ``InferenceEngine`` as ``serve_single``
    drives them (decode a captured step replayed a token, its ids equal to
    the forward loop's bit for bit; K2 or K14 once a layer and step by the
    device trace, no K4, K5 or K6), then phase 3b's twelve requests through
    an 8-slot ``BatchEngine`` over a bf16 cache (StarCoder also over an int8
    cache and through a ``PagedBatchEngine`` with pages of 256, whose ids
    must equal the slot engine's), at ``batch_layers`` of the model's layers
    (all by default). Prints TTFT, ms/token, ms/step, tokens/s, kernels a
    step, idle share and peak memory. Returns {label: launches}."""
    from awq_tpu_torch.config import GenConfig, ModelConfig, QuantConfig, RuntimeConfig
    from awq_tpu_torch.models.llama import init_qparams
    from awq_tpu_torch.runtime.batch_engine import BatchEngine
    from awq_tpu_torch.runtime.engine import InferenceEngine
    from awq_tpu_torch.runtime.paged import PagedBatchEngine

    out = {}
    set_config(None)
    for fam, base in NEW_FAMILIES.items():
        cfg = ModelConfig(**base)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = zero_mean(init_qparams(cfg, QuantConfig(w_bit=4, group_size=G),
                                        torch.Generator(device="cuda").manual_seed(0)), 4)
        if cfg.tie_word_embeddings:
            params["lm_head"] = params["embed"].T.contiguous()
        engine = InferenceEngine(cfg, params, RuntimeConfig(max_seq_len=2048,
                                                            quantize_head=True))
        del params
        torch.cuda.synchronize()
        pos = engine.params.get("pos_embed")
        log(f"  [{fam}] model: {cfg.num_layers} layers, H {cfg.hidden_size}, "
            f"{cfg.num_heads} q heads over {cfg.num_kv_heads} kv heads of {cfg.head_dim}, "
            f"W4-g{G} weights + W4 head {weight_bytes(engine.params) / 1e9:.3f} GB, embedding "
            f"{engine.params['embed'].numel() * 2 / 1e9:.3f} GB"
            + (f", position table {pos.numel() * 2 / 1e9:.3f} GB" if pos is not None else "")
            + f", KV cache {cache_bytes(engine.cache) / 1e9:.4f} GB "
            f"({cache_bytes(engine.cache) // engine.max_seq_len // 1024} KB a position), built "
            f"in {time.perf_counter() - t0:.1f} s")
        torch.cuda.reset_peak_memory_stats()
        launches, ids, _ = serve_single(torch, engine, cfg, (fam,))
        dec = SERVE_PATHS[fam][1][2]
        per_step = round(launches[fam][dec] / (len(REQUESTS) * 31))
        log(f"  [{fam}] {dec} launches per decode step {per_step:g} (one per layer), K3 launches "
            f"per prompt {launches[fam]['flash_prefill'] / len(REQUESTS):g}")
        if per_step != cfg.num_layers:
            raise AssertionError(f"[{fam}] {per_step:g} {dec} launches per decode step, not "
                                 f"{cfg.num_layers}")
        log(f"  [{fam}] peak device memory while serving "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        out.update(launches)
        params = engine.params
        del engine
        n_l = cfg.num_layers if batch_layers is None else min(batch_layers, cfg.num_layers)
        if n_l < cfg.num_layers:
            cfg, params = dataclasses.replace(cfg, num_layers=n_l), cut_layers(params, n_l)
        prompts = batch_prompts(cfg)
        slot_ids = {}
        for kind, (must, off) in NEW_FAMILY_PATHS[fam].items():
            label = f"{fam}_{kind}"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            if kind == "paged":
                engine = PagedBatchEngine(cfg, params, n_slots=BATCH_SLOTS, max_seq_len=2048,
                                          page_size=PAGE)
                kv_bytes = engine.cache.numel() * engine.cache.element_size()
            else:
                engine = BatchEngine(cfg, params, n_slots=BATCH_SLOTS, max_seq_len=2048,
                                     quantize_head=False,
                                     **({"cache_dtype": "int8"} if kind == "batched_int8"
                                        else {}))
                kv_bytes = cache_bytes(engine.cache)
            log(f"  [{label}] {n_l} layers; the {BATCH_SLOTS}-slot cache"
                + (f" ({engine.n_pages} pages of {PAGE})" if kind == "paged" else "")
                + f": {kv_bytes / 2**30:.4f} GiB")
            done, launches, ms_step = drive(torch, engine, prompts, label, cfg)
            slot_ids[kind] = [r.out_ids for r in done]
            check_path(label, launches, ("w4a16_gemv", "w4a16_gemm") + must, _NEW_OFF + off)
            log(f"  [{label}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                "GiB")
            if kind == "paged":
                gen = GenConfig(greedy=True, max_new_tokens=12)
                for i in range(BATCH_SLOTS):
                    engine.submit(prompts[i], gen)
                engine.step()

                def one_step(i):
                    engine.step()
            else:
                def one_step(i):
                    engine._decode().argmax(-1).cpu()
                    engine.lengths += 1

                one_step(0)
            where = f"slot lengths {sorted(int(x) for x in engine.lengths)}"
            prof = profile_steps(torch, one_step, ms_step, label, where, "ms/step")
            inst = decode_instances(prof, 8)
            log(f"  [{label}] the split decode's instances by the device trace, per step: "
                + (", ".join(f"{k} x{v:g}" for k, v in inst.items()) or "none recorded"))
            if any("LayerKV" in k for k in inst):
                raise AssertionError(f"[{label}] K14 (LayerKV) in the batched step's trace")
            if kind == "paged":
                engine.run()
            out[label] = launches
            del engine
        if "paged" in slot_ids:
            if slot_ids["paged"] != slot_ids["batched"]:
                compare_ids(f"{fam}_paged", slot_ids["paged"], slot_ids["batched"],
                            "the slot engine's")
                raise AssertionError(f"[{fam}_paged] greedy ids differ from the slot engine's")
            log(f"  [{fam}_paged] greedy ids equal the bf16 slot engine's for all "
                f"{BATCH_REQUESTS} requests, bit for bit")
            compare_ids(f"{fam}_batched_int8", slot_ids["batched_int8"], slot_ids["batched"],
                        "the bf16 cache's (information: int8 changes the numbers)")
        del params
        torch.cuda.empty_cache()
    return out


def time_prefix_copy(torch, engine, slot: int = 3, reps: int = 5) -> None:
    """Device time of an admission's copy of the prompt's prefix ``[0, S)``
    from the one-slot staging cache into a slot, as ``_prefill_slot`` makes
    it: the median of ``reps`` CUDA-event-timed copies per prompt length,
    against the bytes read and written over the memory rate."""
    from awq_tpu_torch.models.llama import cache_tensors

    pairs = list(zip(cache_tensors(engine.cache), cache_tensors(engine._stage)))
    parts = []
    for s in BATCH_PROMPTS:
        times = []
        for _ in range(reps + 1):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for dst, src in pairs:            # codes and scales for an int8 cache
                dst[:, :, slot, :, :s] = src[:, :, 0, :, :s]
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        nbytes = sum(2 * src[:, :, 0, :, :s].numel() * src.element_size() for _, src in pairs)
        parts.append(f"{s} tokens {statistics.median(times[1:]):.4f} ms "
                     f"({nbytes / 1e6:.1f} MB moved, bound "
                     f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    log("  prefix copy from the staging cache into a slot, by prompt length: "
        + ", ".join(parts))


# label: kernels that must run, kernels that must not, in phase 3g (tensor
# parallel): decode on K12 and K13, every prompt on the stacked path (K1
# GEMM, K3) with the head on K1's GEMV (fp at tp = 4); never K4 or K5
TP_PATHS = {
    "tp1": (("megakernel_attn_half", "megakernel_mlp_half", "w4a16_gemm", "flash_prefill",
             "w4a16_gemv"),
            ("megakernel_token", "megakernel_chunk", "megakernel_attn_half_int8", "flash_decode")),
    "tp1_int8": (("megakernel_attn_half_int8", "megakernel_mlp_half", "w4a16_gemm",
                  "flash_prefill"),
                 ("megakernel_token_int8", "megakernel_attn_half", "flash_decode_int8",
                  "cache_append_int8")),
    "tp2": (("megakernel_attn_half", "megakernel_mlp_half", "w4a16_gemm", "flash_prefill"),
            ("megakernel_token", "megakernel_chunk")),
}
TP2_TIMEOUT_S = 420
# phase 3g (b) serves 8 of the model's layers: its two ranks, time-sliced on
# one card with gloo's all-reduces through the host, took 150-215 ms a token
# and 44 s of the run at 32 layers (NVIDIA H100 80GB HBM3, 700 W), and the
# run keeps within the time its earlier phases and 3j leave
TP2_LAYERS = 8


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def serve_tp(torch, engine, cfg, label):
    """Phase 3's four requests through a tensor-parallel ``engine``, the
    launch counts set to 0 just before and read just after; returns
    (launches, ids, per-request results)."""
    from awq_tpu_torch.config import GenConfig

    gen = GenConfig(greedy=True, max_new_tokens=32)
    engine.warmup()
    rng = torch.Generator().manual_seed(7)
    reset_counters()
    ids_all, results = [], []
    for i, (n, fresh) in enumerate(REQUESTS):
        if fresh:
            engine.reset()
        prompt = torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
        start = engine.start_pos
        out = engine.generate(prompt, gen)
        ids = out["output_ids"]
        if len(ids) != 32 or int(ids.min()) < 0 or int(ids.max()) >= cfg.vocab_size:
            raise AssertionError(f"[{label}] request {i + 1}: bad output ids {ids.tolist()}")
        ids_all.append(ids.tolist())
        tm = out["timing"]
        results.append(dict(prompt=n, start_pos=start, ttft_ms=tm["ttft_s"] * 1e3,
                            ms_per_token=tm["ms_per_token"]))
        log(f"  [{label}] request {i + 1}: prompt {n} at start_pos {start}: TTFT "
            f"{tm['ttft_s'] * 1e3:.2f} ms, {tm['ms_per_token']:.3f} ms/token over 31 decode "
            "steps")
    launches = read_counters()
    return launches, ids_all, results


def phase_serve_tp(torch, layers: int, single_ids):
    """Phase 3g (a): tensor parallelism at tp = 1 over NCCL in this process:
    phase 3's four requests through ``InferenceEngine(RuntimeConfig(mesh=
    ...))`` on phase 3's model (seed 0), with a bf16 and with an int8
    cache; decode on K12 and K13 with an NCCL all-reduce after each. Prints
    TTFT, ms/token, the decode step's kernels and idle share, and how many
    requests' greedy ids equal phase 3's on K4. Returns ({label: launches},
    the group, which stays up for phase 4, the bf16 ids)."""
    from awq_tpu_torch.config import ModelConfig, QuantConfig, RuntimeConfig
    from awq_tpu_torch.models.llama import init_qparams
    from awq_tpu_torch.parallel.distributed import init_distributed
    from awq_tpu_torch.parallel.mesh import make_mesh
    from awq_tpu_torch.parallel.tp import tp_forward
    from awq_tpu_torch.runtime.engine import InferenceEngine

    set_config(None)
    t0 = time.perf_counter()
    init_distributed("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                     world_size=1, local_rank=0, timeout_s=120)
    mesh = make_mesh()
    log(f"  NCCL group of 1 rank on {mesh.device} in {time.perf_counter() - t0:.1f} s")
    cfg = ModelConfig(**{**LLAMA3_8B, "num_layers": layers})
    out, tp1_ids = {}, None
    for label, cache_dtype in (("tp1", torch.bfloat16), ("tp1_int8", "int8")):
        params = init_qparams(cfg, QuantConfig(w_bit=4, group_size=G),
                              torch.Generator(device="cuda").manual_seed(0))
        engine = InferenceEngine(cfg, params, RuntimeConfig(max_seq_len=2048, quantize_head=True,
                                                            mesh=mesh), cache_dtype=cache_dtype)
        del params                                # serving's peak, the build left out
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launches, ids, res = serve_tp(torch, engine, cfg, label)
        log(f"  [{label}] launches during the four requests: "
            f"{ {k: v for k, v in launches.items() if v} }")
        check_path(label, launches, *TP_PATHS[label])
        log(f"  [{label}] peak device memory while serving "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        compare_ids(label, ids, single_ids, "phase 3's on K4")
        tok = torch.zeros((1, 1), dtype=torch.long, device="cuda")
        pos = engine.start_pos
        profile_steps(torch, lambda i: tp_forward(engine.params, engine.cfg, tok, engine.cache,
                                                  pos + 1 + i, mesh),
                      res[-1]["ms_per_token"], label, f"position {pos + 1}", "ms/token")
        out[label] = launches
        tp1_ids = tp1_ids or ids
        del engine
        torch.cuda.empty_cache()
    return out, mesh, tp1_ids


def tp2_rank(rank: int, store_path: str, layers: int, out_path: str) -> None:
    """One of phase 3g (b)'s two ranks: a gloo group over a FileStore, both
    ranks on card 0 (the default device under gloo); phase 3's model drawn
    from its seed on the card and moved to the host, the stand-in for a
    checkpoint loaded there, so that the card holds nothing of it; then the
    engine's build (the rank's deploy shard sliced on the host, only the
    shard moved to the card) and phase 3's four requests. Writes its ids,
    timings, launches, build time and peak memory from the build on to
    ``out_path`` (JSON)."""
    import torch
    import torch.distributed as dist

    from awq_tpu_torch.config import ModelConfig, QuantConfig, RuntimeConfig
    from awq_tpu_torch.models.llama import init_qparams, params_to
    from awq_tpu_torch.parallel.distributed import init_distributed
    from awq_tpu_torch.parallel.mesh import make_mesh
    from awq_tpu_torch.runtime.engine import InferenceEngine

    device = init_distributed("gloo", rank=rank, world_size=2, timeout_s=TP2_TIMEOUT_S,
                              store=dist.FileStore(store_path, 2))
    mesh = make_mesh()
    if mesh.device != device or device.type != "cuda":
        raise AssertionError(f"rank {rank}: group on {mesh.device}, init on {device}")
    cfg = ModelConfig(**{**LLAMA3_8B, "num_layers": layers})
    params = params_to(init_qparams(cfg, QuantConfig(w_bit=4, group_size=G),
                                    torch.Generator(device="cuda").manual_seed(0)), "cpu")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, params, RuntimeConfig(max_seq_len=2048, quantize_head=True,
                                                        mesh=mesh))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del params
    launches, ids, res = serve_tp(torch, engine, cfg, f"tp2 rank {rank}")
    with open(out_path, "w") as f:
        json.dump(dict(ids=ids, results=res, launches=launches, build_s=build_s,
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                       weight_gb=weight_bytes(engine.params) / 1e9), f)
    dist.destroy_process_group()


def phase_serve_tp2(torch, layers: int, tp1_ids, single_ids):
    """Phase 3g (b): tensor parallelism at tp = 2 over gloo, two spawned
    processes sharing the one card (time-sliced, so no TP speed-up), each
    a rank with its shard of phase 3's model: the four requests, greedy ids
    against (a)'s and phase 3's, each rank's peak memory and ms/token.
    Returns rank 0's launches."""
    import multiprocessing as mp

    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "tp_smoke")
    os.makedirs(tmp, exist_ok=True)
    store = os.path.join(tmp, f"store-{os.getpid()}")
    if os.path.exists(store):
        os.unlink(store)
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=tp2_rank, args=(r, store, layers, outs[r])) for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(1.0, TP2_TIMEOUT_S - (time.perf_counter() - t0)))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"tp2: ranks {hung} hung, exit codes "
                             f"{[p.exitcode for p in procs]}")
    got = []
    for r, path in enumerate(outs):
        with open(path) as f:
            got.append(json.load(f))
    log(f"  two ranks in {time.perf_counter() - t0:.1f} s (spawn, build, serve)")
    if got[0]["ids"] != got[1]["ids"]:
        raise AssertionError("tp2: the two ranks chose different ids")
    check_path("tp2", got[0]["launches"], *TP_PATHS["tp2"])
    for r, g in enumerate(got):
        log(f"  [tp2 rank {r}] shard {g['weight_gb']:.3f} GB of W4 weights and head, built "
            f"from the host in {g['build_s']:.1f} s; peak device memory from the build on "
            f"{g['peak_gib']:.2f} GiB; ms/token (two ranks "
            "time-sliced on one card, gloo all-reduces through the host): " + ", ".join(
                f"{x['ms_per_token']:.2f}" for x in g["results"]) + "; TTFT ms: " + ", ".join(
                f"{x['ttft_ms']:.1f}" for x in g["results"]))
    if tp1_ids is None:
        log(f"  [tp2] {layers} layers: the ids are not compared with (a)'s and phase 3's")
    else:
        compare_ids("tp2", got[0]["ids"], tp1_ids, "(a)'s at tp = 1")
        compare_ids("tp2", got[0]["ids"], single_ids, "phase 3's on K4")
    return got[0]["launches"]


def phase_model_parity_tp(torch, mesh):
    """Phase 4, tensor parallel at tp = 1 (the NCCL group of phase 3g): a
    2-layer model's 100-token prefill (stacked) and 8 decodes (K12, K13)
    through ``tp_forward``, kernel path against plain path, over a bf16
    and an int8 cache."""
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama
    from awq_tpu_torch.parallel.deploy import build_tp_params
    from awq_tpu_torch.parallel.tp import tp_forward

    cfg = ModelConfig(**{**LLAMA3_8B, "num_layers": 2})
    params = build_tp_params(llama.init_qparams(
        cfg, QuantConfig(w_bit=4, group_size=G), torch.Generator(device="cuda").manual_seed(1)),
        cfg, mesh, quantize_head=True)
    tol = 5e-2       # as the single-device parity above
    set_config(None)
    for label, dt in (("tp1", torch.bfloat16), ("tp1_int8", "int8")):
        caches = [llama.init_cache(cfg, 1, 512, dt) for _ in range(2)]
        reset_counters()
        rng = torch.Generator().manual_seed(3)
        steps = [torch.randint(0, cfg.vocab_size, (1, 100), generator=rng)] + [
            torch.randint(0, cfg.vocab_size, (1, 1), generator=rng) for _ in range(8)]
        pos, agree, worst = 0, 0, 0.0
        for toks in steps:
            toks = toks.cuda()
            got = tp_forward(params, cfg, toks, caches[0], pos, mesh)[0]
            ref = tp_forward(params, cfg, toks, caches[1], pos, mesh, impl="plain")[0]
            err, rel = check(f"[{label}] tp_forward at start_pos {pos}", got, ref, tol)
            worst = max(worst, rel)
            agree += int(torch.equal(got[:, -1].argmax(-1), ref[:, -1].argmax(-1)))
            pos += toks.shape[1]
        launches = read_counters()
        half = "megakernel_attn_half" + ("_int8" if label.endswith("int8") else "")
        if launches[half] != 8 * 2 or launches["megakernel_mlp_half"] != 8 * 2:
            raise AssertionError(f"[{label}] expected 16 launches of each half, got "
                                 f"{launches[half]} and {launches['megakernel_mlp_half']}")
        log(f"  [{label}] tp_forward, 100-token prefill + 8 decodes, logits kernel vs plain: "
            f"worst max_abs_err/max|ref| {worst:.3e} (tol {tol:g}); greedy ids agree on "
            f"{agree}/{len(steps)} steps")


def phase_model_parity(torch):
    """Phase 4: kernel path vs plain path through forward, 2 layers, on the
    stacked path and on the megakernels, over a bf16 and an int8 cache; one
    batched step on each path and one paged step; the int8-activation
    prefill with the int8 weight cache (K11) and without it (K10)."""
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama
    from awq_tpu_torch.ops import cache_append as ca

    cfg = ModelConfig(**{**LLAMA3_8B, "num_layers": 2})
    params = llama.init_qparams(cfg, QuantConfig(w_bit=4, group_size=G),
                                torch.Generator(device="cuda").manual_seed(1))
    params = llama.fuse_linears(llama.quantize_head(params, cfg), cfg)
    # bf16 model: the two paths round differently at every layer; 5e-2 of
    # the largest logit bounds their drift over two layers
    tol = 5e-2
    for label, disable, prompt in (("stacked", "1", 100), ("megakernels", None, 20),
                                   ("stacked_int8", "1", 100), ("megakernels_int8", None, 20)):
        # the int8 cache (KVCache8): the prefill takes the stacked path either
        # way (K5 takes no int8 cache); decode takes K9 and its int8
        # append, or K4's int8 mode
        set_config(disable)
        caches = [llama.init_cache(cfg, 1, 512, "int8" if label.endswith("int8")
                                   else torch.bfloat16) for _ in range(2)]
        reset_counters()
        rng = torch.Generator().manual_seed(3)
        steps = [torch.randint(0, cfg.vocab_size, (1, prompt), generator=rng)] + [
            torch.randint(0, cfg.vocab_size, (1, 1), generator=rng) for _ in range(8)]
        pos, agree, worst = 0, 0, 0.0
        for toks in steps:
            toks = toks.cuda()
            got, _ = llama.forward(params, cfg, toks, caches[0], pos)
            ref, _ = llama.forward(params, cfg, toks, caches[1], pos, impl="plain")
            err, rel = check(f"[{label}] forward at start_pos {pos}", got, ref, tol)
            worst = max(worst, rel)
            agree += int(torch.equal(got[:, -1].argmax(-1), ref[:, -1].argmax(-1)))
            pos += toks.shape[1]
        log(f"  [{label}] {prompt}-token prefill + 8 decodes, logits kernel vs plain: "
            f"worst max_abs_err/max|ref| {worst:.3e} (tol {tol:g}); greedy ids agree "
            f"on {agree}/{len(steps)} steps")
        if label.endswith("int8"):
            check_path(label, read_counters(), *SERVE_PATHS[label][1:])
    # one continuous-batching step of 8 rows at ragged lengths (row 1 empty)
    # over a random cache: K6, then the stacked batched path (K1, K2 appending)
    gen = torch.Generator(device="cuda").manual_seed(5)
    ragged = [300, 0, 17, 511 - 1, 64, 255, 128, 5]
    lens = torch.tensor(ragged, dtype=torch.int32, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (8,), generator=gen, device="cuda")
    base = llama.init_kv_cache(cfg, 8, 512)
    base.normal_(generator=gen)
    for label, disable in (("batched", None), ("batched_stacked", "1")):
        set_config(disable)
        caches = [base.clone(), base.clone()]
        got, _ = llama.decode_step_batched(params, cfg, toks, caches[0], lens,
                                           max_length=max(ragged))
        ref, _ = llama.decode_step_batched(params, cfg, toks, caches[1], lens, impl="plain")
        torch.cuda.synchronize()
        err, rel = check(f"[{label}] decode_step_batched logits", got, ref, tol)
        cerr, _ = check(f"[{label}] decode_step_batched cache", caches[0], caches[1], tol)
        agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
        log(f"  [{label}] decode_step_batched, 8 rows at lengths {ragged}, kernel vs plain: "
            f"logits max_abs_err/max|ref| {rel:.3e} (tol {tol:g}), cache max_abs_err "
            f"{cerr:.3e}; greedy ids agree on {agree}/8 rows")
    # the same step over the int8 cache (the random cache quantized): K6's
    # int8 slot mode, then the stacked path (K1, K9 with its int8 append)
    base8 = quantize_cache(torch, base)
    for label, disable in (("batched_int8", None), ("batched_stacked_int8", "1")):
        set_config(disable)
        caches = [llama.KVCache8(*(x.clone() for x in base8)) for _ in range(2)]
        reset_counters()
        got, _ = llama.decode_step_batched(params, cfg, toks, caches[0], lens,
                                           max_length=max(ragged))
        ref, _ = llama.decode_step_batched(params, cfg, toks, caches[1], lens, impl="plain")
        torch.cuda.synchronize()
        must = ("megakernel_batched_int8",) if disable is None else (
            "flash_decode_int8", "cache_append_int8")
        check_path(label, read_counters(), must, ())
        err, rel = check(f"[{label}] decode_step_batched logits", got, ref, tol)
        cerr, _ = check(f"[{label}] decode_step_batched cache, dequantized",
                        ca.dequantize_kv(*caches[0]), ca.dequantize_kv(*caches[1]), tol)
        agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
        log(f"  [{label}] decode_step_batched over the int8 cache, the same rows, kernel vs "
            f"plain: logits max_abs_err/max|ref| {rel:.3e} (tol {tol:g}), dequantized cache "
            f"max_abs_err {cerr:.3e}; greedy ids agree on {agree}/8 rows")
    del base8
    # the same step paged: pages of 128 over a permuted pool; K6's paged
    # mode, then the stacked paged path (K1, K8 with its paged append)
    pool, tables = scatter_pages(torch, base, 4, 128, gen)
    for label, disable in (("paged", None), ("paged_stacked", "1")):
        set_config(disable)
        pools = [pool.clone(), pool.clone()]
        got, _ = llama.decode_step_paged(params, cfg, toks, pools[0], tables, lens,
                                         max_length=max(ragged))
        ref, _ = llama.decode_step_paged(params, cfg, toks, pools[1], tables, lens,
                                         impl="plain")
        torch.cuda.synchronize()
        err, rel = check(f"[{label}] decode_step_paged logits", got, ref, tol)
        cerr, _ = check(f"[{label}] decode_step_paged pool", pools[0], pools[1], tol)
        agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
        log(f"  [{label}] decode_step_paged, the same rows over a permuted pool of pages of "
            f"128, kernel vs plain: logits max_abs_err/max|ref| {rel:.3e} (tol {tol:g}), "
            f"pool max_abs_err {cerr:.3e}; greedy ids agree on {agree}/8 rows")
    set_config(None)
    # the int8-activation prefill through forward: the int8 weight cache
    # (K11) on a 100-token prompt and prefill_a8 alone (K10) on 600 tokens.
    # K10 and K11 equal their plain versions; the rest of the path rounds
    # as above: the same 5e-2
    import dataclasses

    from awq_tpu_torch.ops import w4a16 as w4

    cfg8 = dataclasses.replace(cfg, prefill_a8=True)
    params_w8 = dict(params)
    params_w8["layers"] = w4.attach_w8_caches(params["layers"])
    rng = torch.Generator().manual_seed(8)
    for label, p, prompt, kern in (("prefill_w8", params_w8, 100, "w8a8_gemm"),
                                   ("prefill_a8", params, 600, "w4a8_gemm")):
        caches = [llama.init_cache(cfg8, 1, 1024) for _ in range(2)]
        toks = torch.randint(0, cfg.vocab_size, (1, prompt), generator=rng).cuda()
        reset_counters()
        got, _ = llama.forward(p, cfg8, toks, caches[0], 0)
        launches = read_counters()
        ref, _ = llama.forward(p, cfg8, toks, caches[1], 0, impl="plain")
        torch.cuda.synchronize()
        n_lin = 4 * cfg.num_layers
        if launches[kern] != n_lin or launches["quant_per_token"] != n_lin:
            raise AssertionError(f"[{label}] {launches[kern]} {kern} and "
                                 f"{launches['quant_per_token']} quant_per_token launches, "
                                 f"not {n_lin} each")
        err, rel = check(f"[{label}] forward, {prompt}-token prefill", got, ref, tol)
        cerr, _ = check(f"[{label}] the cache the prefill wrote", caches[0], caches[1], tol)
        log(f"  [{label}] {prompt}-token prefill, logits kernel vs plain: max_abs_err/max|ref| "
            f"{rel:.3e} (tol {tol:g}), cache max_abs_err {cerr:.3e}; {launches[kern]} {kern} "
            "launches; greedy ids agree: "
            f"{bool(torch.equal(got[:, -1].argmax(-1), ref[:, -1].argmax(-1)))}")


def to_f32(torch, x):
    """Every floating tensor of a parameter tree in f32; the W4 codes as
    they are."""
    if isinstance(x, dict):
        return {k: to_f32(torch, v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.float() if x.is_floating_point() else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: to_f32(torch, getattr(x, f.name))
                                         for f in dataclasses.fields(x)
                                         if isinstance(getattr(x, f.name), torch.Tensor)})
    return x


def phase_model_parity_falcon(torch):
    """Phase 4, falcon: a 2-layer Falcon-7B-width model (W4-g64 layers and
    head, bf16 cache) through forward, the kernel path (K1, K3's head_dim-64
    mode, K14) against ``impl="plain"`` over a 100-token prefill and 16
    decode steps, within 5e-2 of the largest logit as phase 4's llama
    models; K14 must launch once per layer and step, K3 once per layer.

    Both bf16 paths are also held to the same model evaluated in f32
    (``impl="plain"``, the same W4 codes, f32 activations and cache): this
    model's bf16 rounding alone puts the plain path 3.3e-2 from it, so the
    kernel path must come no further from it than 1.25 times the plain
    path does. A kernel that is partly wrong moves away from the f32 model;
    the two bf16 paths' rounding does not."""
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama

    cfg = ModelConfig(**{**FALCON_7B, "num_layers": 2})
    params = llama.init_qparams(cfg, QuantConfig(w_bit=4, group_size=FALCON_G),
                                torch.Generator(device="cuda").manual_seed(1))
    params = llama.fuse_linears(llama.quantize_head(params, cfg), cfg)
    cfg32, params32 = dataclasses.replace(cfg, dtype="float32"), to_f32(torch, params)
    tol, tol32 = 5e-2, 1.25
    caches = [llama.init_cache(cfg, 1, 512) for _ in range(2)]
    cache32 = llama.init_cache(cfg32, 1, 512, torch.float32)
    rng = torch.Generator().manual_seed(3)
    steps = [torch.randint(0, cfg.vocab_size, (1, 100), generator=rng)] + [
        torch.randint(0, cfg.vocab_size, (1, 1), generator=rng) for _ in range(16)]
    pos, agree, worst, launches = 0, 0, 0.0, {}
    worst32 = {"kernels": 0.0, "plain": 0.0}
    for toks in steps:
        toks = toks.cuda()
        reset_counters()
        got, _ = llama.forward(params, cfg, toks, caches[0], pos)
        for k, v in read_counters().items():
            launches[k] = launches.get(k, 0) + v
        ref, _ = llama.forward(params, cfg, toks, caches[1], pos, impl="plain")
        ref32, _ = llama.forward(params32, cfg32, toks, cache32, pos, impl="plain")
        err, rel = check(f"[falcon] forward at start_pos {pos}", got, ref, tol)
        worst = max(worst, rel)
        for name, logits in (("kernels", got), ("plain", ref)):
            worst32[name] = max(worst32[name], check(
                f"[falcon] {name} against f32 at start_pos {pos}", logits, ref32, 1.0)[1])
        agree += int(torch.equal(got[:, -1].argmax(-1), ref[:, -1].argmax(-1)))
        pos += toks.shape[1]
    cerr, _ = check("[falcon] the cache", caches[0], caches[1], tol)
    if worst32["kernels"] > tol32 * worst32["plain"]:
        raise AssertionError(f"[falcon] the kernel path lies {worst32['kernels']:.3e} of the "
                             f"largest logit from the f32 model, more than {tol32:g} x the "
                             f"plain path's {worst32['plain']:.3e}")
    n_l = cfg.num_layers
    if launches["flash_decode_layer"] != 16 * n_l or launches["flash_prefill"] != n_l:
        raise AssertionError(f"[falcon] {launches['flash_decode_layer']} K14 and "
                             f"{launches['flash_prefill']} K3 launches, not {16 * n_l} and {n_l}")
    check_path("falcon", launches, *SERVE_PATHS["falcon"][1:])
    log(f"  [falcon] 100-token prefill + 16 decodes, 2 layers, logits kernel vs plain: worst "
        f"max_abs_err/max|ref| {worst:.3e} (tol {tol:g}), cache max_abs_err {cerr:.3e}; "
        f"against the f32 model: kernel path {worst32['kernels']:.3e}, plain path "
        f"{worst32['plain']:.3e} (tol {tol32:g} x the plain path's); greedy ids agree on "
        f"{agree}/{len(steps)} steps; {launches['flash_decode_layer']} K14 and "
        f"{launches['flash_prefill']} K3 launches")


def phase_model_parity_alibi(torch):
    """Phase 4, the ALiBi families at 2 layers, kernel path against
    ``impl="plain"`` through ``forward``, within 5e-2 of the largest logit as
    phase 4's llama models: MPT-7B's widths (W4-g128 zero-mean layers and the
    tied head quantized) over a 100-token prefill and 8 decode steps on K4's MPT shape
    and on the stacked path (K2 with slopes); BLOOM-560m's widths (W4-g128,
    random biases) over a 100-token prefill and 16 decode steps on the
    stacked path, K14 with slopes once per layer and step and K3 with slopes
    once per layer. Returns {"bloom": launches}."""
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama
    from awq_tpu_torch.ops.w4a16 import QLinear

    tol = 5e-2
    out = {}
    for label, base, disable, n_dec in (("mpt", MPT_7B, None, 8),
                                        ("mpt_stacked", MPT_7B, "1", 8),
                                        ("bloom", BLOOM_560M, None, 16)):
        set_config(disable)
        cfg = ModelConfig(**{**base, "num_layers": 2})
        gen = torch.Generator(device="cuda").manual_seed(1)
        params = zero_mean(llama.init_qparams(cfg, QuantConfig(w_bit=4, group_size=G), gen), 4)
        for p in params["layers"].values():
            if isinstance(p, QLinear) and p.bias is not None:
                p.bias.copy_(torch.randn(p.bias.shape, generator=gen, device="cuda") * 0.05)
        params["lm_head"] = params["embed"].T.contiguous()
        params = llama.fuse_linears(llama.quantize_head(params, cfg), cfg)
        caches = [llama.init_cache(cfg, 1, 512) for _ in range(2)]
        rng = torch.Generator().manual_seed(3)
        steps = [torch.randint(0, cfg.vocab_size, (1, 100), generator=rng)] + [
            torch.randint(0, cfg.vocab_size, (1, 1), generator=rng) for _ in range(n_dec)]
        pos, agree, worst, launches = 0, 0, 0.0, {}
        for toks in steps:
            toks = toks.cuda()
            reset_counters()
            got, _ = llama.forward(params, cfg, toks, caches[0], pos)
            for k, v in read_counters().items():
                launches[k] = launches.get(k, 0) + v
            ref, _ = llama.forward(params, cfg, toks, caches[1], pos, impl="plain")
            err, rel = check(f"[{label}] forward at start_pos {pos}", got, ref, tol)
            worst = max(worst, rel)
            agree += int(torch.equal(got[:, -1].argmax(-1), ref[:, -1].argmax(-1)))
            pos += toks.shape[1]
        cerr, _ = check(f"[{label}] the cache", caches[0], caches[1], tol)
        n_l = cfg.num_layers
        want = {"mpt": {"megakernel_token_mpt": n_dec, "flash_prefill_alibi": n_l},
                "mpt_stacked": {"flash_decode_alibi": n_dec * n_l, "flash_prefill_alibi": n_l},
                "bloom": {"flash_decode_layer_alibi": n_dec * n_l,
                          "flash_prefill_alibi": n_l}}[label]
        if any(launches.get(k, 0) != v for k, v in want.items()):
            raise AssertionError(f"[{label}] launches {nonzero(launches)}, want {want}")
        check_path(label, launches, *SERVE_PATHS[label][1:])
        log(f"  [{label}] 100-token prefill + {n_dec} decodes, 2 layers, logits kernel vs "
            f"plain: worst max_abs_err/max|ref| {worst:.3e} (tol {tol:g}), cache max_abs_err "
            f"{cerr:.3e}; greedy ids agree on {agree}/{len(steps)} steps; launches "
            f"{nonzero(launches)}")
        out[label] = launches
        del params, caches
        torch.cuda.empty_cache()
    set_config(None)
    return {"bloom": out["bloom"]}


def phase_model_parity_families_batched(torch):
    """Phase 4, the families' per-row steps at 2 layers: Falcon-7B's widths
    (W4-g64), MPT-7B's and BLOOM-560m's (W4-g128 zero-mean, BLOOM's random
    biases), one ``decode_step_batched`` of 8 rows at ragged lengths over a
    bf16 cache and over its int8 quantization, and one ``decode_step_paged``
    of the same rows over a permuted pool of pages of 256; kernel path
    against ``impl="plain"`` within 5e-2 of the largest logit (and of the
    cache's largest value, dequantized for int8), as phase 4's llama steps.
    Each step must launch its mode of K2, K9 or K8 once a layer (falcon:
    head_dim 64 and 71 q heads a kv head; MPT, BLOOM: with ALiBi slopes) and
    no K14. Returns {label: launches}."""
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama
    from awq_tpu_torch.ops import cache_append as ca
    from awq_tpu_torch.ops.w4a16 import QLinear

    tol, out = 5e-2, {}
    ragged = [300, 0, 17, 511 - 1, 64, 255, 128, 5]
    set_config(None)
    for fam, base, group, tag in (("falcon", FALCON_7B, FALCON_G, "_wide"),
                                  ("mpt", MPT_7B, G, "_alibi"),
                                  ("bloom", BLOOM_560M, G, "_alibi")):
        cfg = ModelConfig(**{**base, "num_layers": 2})
        gen = torch.Generator(device="cuda").manual_seed(7)
        params = llama.init_qparams(cfg, QuantConfig(w_bit=4, group_size=group), gen)
        if fam != "falcon":
            params = zero_mean(params, 4)
            for p in params["layers"].values():
                if isinstance(p, QLinear) and p.bias is not None:
                    p.bias.copy_(torch.randn(p.bias.shape, generator=gen, device="cuda") * 0.05)
            params["lm_head"] = params["embed"].T.contiguous()
        params = llama.fuse_linears(llama.quantize_head(params, cfg), cfg)
        lens = torch.tensor(ragged, dtype=torch.int32, device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (8,), generator=gen, device="cuda")
        cache = llama.init_kv_cache(cfg, 8, 512)
        cache.normal_(generator=gen)
        pool, tables = scatter_pages(torch, cache, 2, PAGE, gen)
        n_l = cfg.num_layers
        for kind, counter in (("batched", "flash_decode"), ("batched_int8", "flash_decode_int8"),
                              ("paged", "flash_decode_paged")):
            label = f"{fam}_{kind}"
            if kind == "batched":
                states = [cache.clone(), cache.clone()]
            elif kind == "paged":
                states = [pool.clone(), pool.clone()]
            else:
                c8 = quantize_cache(torch, cache)
                states = [llama.KVCache8(*(x.clone() for x in c8)) for _ in range(2)]
            step = (lambda st, **kw: llama.decode_step_paged(params, cfg, toks, st, tables, lens,
                                                             **kw)) if kind == "paged" else (
                lambda st, **kw: llama.decode_step_batched(params, cfg, toks, st, lens, **kw))
            reset_counters()
            got, _ = step(states[0], max_length=max(ragged))
            launches = read_counters()
            ref, _ = step(states[1], impl="plain")
            torch.cuda.synchronize()
            if launches[counter + tag] != n_l or launches["flash_decode_layer"] \
                    or launches["flash_decode_layer_alibi"]:
                raise AssertionError(f"[{label}] launches {nonzero(launches)}: want "
                                     f"{counter + tag} x{n_l} and no K14")
            err, rel = check(f"[{label}] logits", got, ref, tol)
            if kind == "batched_int8":
                cerr, _ = check(f"[{label}] the cache, dequantized", ca.dequantize_kv(*states[0]),
                                ca.dequantize_kv(*states[1]), tol)
            else:
                cerr, _ = check(f"[{label}] the cache", states[0], states[1], tol)
            agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
            log(f"  [{label}] 8 rows at lengths {ragged}, 2 layers, kernel vs plain: logits "
                f"max_abs_err/max|ref| {rel:.3e} (tol {tol:g}), cache max_abs_err {cerr:.3e}; "
                f"greedy ids agree on {agree}/8 rows; launches {nonzero(launches)}")
            out["parity_" + label] = launches
            del states
        del params, cache, pool
        torch.cuda.empty_cache()
    return out


def phase_model_parity_new_families(torch):
    """Phase 4, phase 3l's families at 2 layers of OPT-6.7B's, StarCoder's
    and Pythia-6.9B's widths (W4-g128 zero-mean layers, random biases, the
    head quantized; OPT's and StarCoder's the tied embedding): a 100-token
    prefill and 8 decode steps through ``forward`` (K1, K3, and K2 or K14
    once a layer and step), then one ``decode_step_batched`` of 8 rows at
    ragged lengths over a bf16 cache (StarCoder also over its int8
    quantization, and one ``decode_step_paged`` over a permuted pool of
    pages of 256), kernel path against ``impl="plain"`` within 5e-2 of the
    largest logit (and of the cache's largest value), as phase 4's other
    models. Returns {label: launches}."""
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama
    from awq_tpu_torch.ops import cache_append as ca
    from awq_tpu_torch.ops.w4a16 import QLinear

    tol, out = 5e-2, {}
    ragged = [300, 0, 17, 511 - 1, 64, 255, 128, 5]
    set_config(None)
    for fam, base in NEW_FAMILIES.items():
        cfg = ModelConfig(**{**base, "num_layers": 2})
        gen = torch.Generator(device="cuda").manual_seed(9)
        params = zero_mean(llama.init_qparams(cfg, QuantConfig(w_bit=4, group_size=G), gen), 4)
        for p in params["layers"].values():
            if isinstance(p, QLinear) and p.bias is not None:
                p.bias.copy_(torch.randn(p.bias.shape, generator=gen, device="cuda") * 0.05)
        if cfg.tie_word_embeddings:
            params["lm_head"] = params["embed"].T.contiguous()
        params = llama.fuse_linears(llama.quantize_head(params, cfg), cfg)
        dec = SERVE_PATHS[fam][1][2]
        caches = [llama.init_cache(cfg, 1, 512) for _ in range(2)]
        rng = torch.Generator().manual_seed(3)
        steps = [torch.randint(0, cfg.vocab_size, (1, 100), generator=rng)] + [
            torch.randint(0, cfg.vocab_size, (1, 1), generator=rng) for _ in range(8)]
        pos, worst, launches = 0, 0.0, {}
        for toks in steps:
            toks = toks.cuda()
            reset_counters()
            got, _ = llama.forward(params, cfg, toks, caches[0], pos)
            for k, v in read_counters().items():
                launches[k] = launches.get(k, 0) + v
            ref, _ = llama.forward(params, cfg, toks, caches[1], pos, impl="plain")
            worst = max(worst, check(f"[{fam}] forward at start_pos {pos}", got, ref, tol)[1])
            pos += toks.shape[1]
        cerr, _ = check(f"[{fam}] the cache", caches[0], caches[1], tol)
        if launches[dec] != 8 * cfg.num_layers or launches["flash_prefill"] != cfg.num_layers:
            raise AssertionError(f"[{fam}] {launches[dec]} {dec} and {launches['flash_prefill']} "
                                 f"K3 launches, not {8 * cfg.num_layers} and {cfg.num_layers}")
        check_path(fam, launches, *SERVE_PATHS[fam][1:])
        log(f"  [{fam}] 100-token prefill + 8 decodes, 2 layers, logits kernel vs plain: worst "
            f"max_abs_err/max|ref| {worst:.3e} (tol {tol:g}), cache max_abs_err {cerr:.3e}; "
            f"launches {nonzero(launches)}")
        out["parity_" + fam] = launches
        del caches
        lens = torch.tensor(ragged, dtype=torch.int32, device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (8,), generator=gen, device="cuda")
        cache = llama.init_kv_cache(cfg, 8, 512)
        cache.normal_(generator=gen)
        kinds = NEW_FAMILY_PATHS[fam]
        pool = tables = None
        if "paged" in kinds:
            pool, tables = scatter_pages(torch, cache, 2, PAGE, gen)
        for kind, (must, _) in kinds.items():
            label = f"{fam}_{kind}"
            if kind == "batched":
                states = [cache.clone(), cache.clone()]
            elif kind == "paged":
                states = [pool.clone(), pool.clone()]
            else:
                c8 = quantize_cache(torch, cache)
                states = [llama.KVCache8(*(x.clone() for x in c8)) for _ in range(2)]
            step = (lambda st, **kw: llama.decode_step_paged(params, cfg, toks, st, tables, lens,
                                                             **kw)) if kind == "paged" else (
                lambda st, **kw: llama.decode_step_batched(params, cfg, toks, st, lens, **kw))
            reset_counters()
            got, _ = step(states[0], max_length=max(ragged))
            launches = read_counters()
            ref, _ = step(states[1], impl="plain")
            torch.cuda.synchronize()
            if launches[must[0]] != cfg.num_layers or launches["flash_decode_layer"]:
                raise AssertionError(f"[{label}] launches {nonzero(launches)}: want "
                                     f"{must[0]} x{cfg.num_layers} and no K14")
            err, rel = check(f"[{label}] logits", got, ref, tol)
            if kind == "batched_int8":
                cerr, _ = check(f"[{label}] the cache, dequantized", ca.dequantize_kv(*states[0]),
                                ca.dequantize_kv(*states[1]), tol)
            else:
                cerr, _ = check(f"[{label}] the cache", states[0], states[1], tol)
            log(f"  [{label}] 8 rows at lengths {ragged}, 2 layers, kernel vs plain: logits "
                f"max_abs_err/max|ref| {rel:.3e} (tol {tol:g}), cache max_abs_err {cerr:.3e}; "
                f"greedy ids agree on {int((got.argmax(-1) == ref.argmax(-1)).sum())}/8 rows; "
                f"launches {nonzero(launches)}")
            out["parity_" + label] = launches
            del states
        del params, cache, pool
        torch.cuda.empty_cache()
    return out


def phase_model_parity_w3_f16(torch):
    """Phase 4, continued: a 2-layer W3 model (pack_int3 linears and head)
    through forward on the stacked path (K1's W3 mode) and on the
    megakernels (K4, K5 W3 modes), one decode_step_batched (K6 W3) and one
    decode_step_paged (K6's paged W3 mode) of 8 ragged rows, kernel path
    against plain path; then an f16 W4 model with an f16 cache on the
    stacked path (K1, K2, K3 over f16). Tolerance 5e-2 of the largest
    logit, as for the W4 model."""
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama

    tol = 5e-2
    gen = torch.Generator(device="cuda").manual_seed(6)

    def run_forward(label, params, cfg, disable, prompt, must, dtype):
        set_config(disable)
        caches = [llama.init_cache(cfg, 1, 512, dtype) for _ in range(2)]
        reset_counters()
        rng = torch.Generator().manual_seed(3)
        steps = [torch.randint(0, cfg.vocab_size, (1, prompt), generator=rng)] + [
            torch.randint(0, cfg.vocab_size, (1, 1), generator=rng) for _ in range(8)]
        pos, agree, worst = 0, 0, 0.0
        for toks in steps:
            toks = toks.cuda()
            got, _ = llama.forward(params, cfg, toks, caches[0], pos)
            ref, _ = llama.forward(params, cfg, toks, caches[1], pos, impl="plain")
            err, rel = check(f"[{label}] forward at start_pos {pos}", got, ref, tol)
            worst = max(worst, rel)
            agree += int(torch.equal(got[:, -1].argmax(-1), ref[:, -1].argmax(-1)))
            pos += toks.shape[1]
        check_path(label, read_counters(), must, ())
        log(f"  [{label}] {prompt}-token prefill + 8 decodes, logits kernel vs plain: "
            f"worst max_abs_err/max|ref| {worst:.3e} (tol {tol:g}); greedy ids agree "
            f"on {agree}/{len(steps)} steps")

    cfg = ModelConfig(**{**LLAMA3_8B, "num_layers": 2})
    params = llama.init_qparams(cfg, QuantConfig(w_bit=3, group_size=G),
                                torch.Generator(device="cuda").manual_seed(1))
    params = llama.fuse_linears(llama.quantize_head(params, cfg), cfg)
    assert params["lm_head"].dense3
    run_forward("stacked_w3", params, cfg, "1", 100, ("w3a16_gemv", "w3a16_gemm"),
                torch.bfloat16)
    run_forward("megakernels_w3", params, cfg, None, 20,
                ("megakernel_token_w3", "megakernel_chunk_w3"), torch.bfloat16)
    ragged = [300, 0, 17, 511 - 1, 64, 255, 128, 5]
    lens = torch.tensor(ragged, dtype=torch.int32, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (8,), generator=gen, device="cuda")
    base = llama.init_kv_cache(cfg, 8, 512)
    base.normal_(generator=gen)
    pool, tables = scatter_pages(torch, base, 4, 128, gen)
    set_config(None)
    for label, step, cache, kw, must in (
            ("batched_w3", llama.decode_step_batched, base, {}, "megakernel_batched_w3"),
            ("paged_w3", llama.decode_step_paged, pool, {"tables": tables},
             "megakernel_batched_paged_w3")):
        caches = [cache.clone(), cache.clone()]
        reset_counters()
        args = (params, cfg, toks)
        if kw:
            got, _ = step(*args, caches[0], tables, lens, max_length=max(ragged))
            ref, _ = step(*args, caches[1], tables, lens, impl="plain")
        else:
            got, _ = step(*args, caches[0], lens, max_length=max(ragged))
            ref, _ = step(*args, caches[1], lens, impl="plain")
        torch.cuda.synchronize()
        check_path(label, read_counters(), (must,), ())
        err, rel = check(f"[{label}] one step's logits", got, ref, tol)
        cerr, _ = check(f"[{label}] one step's cache", caches[0], caches[1], tol)
        agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
        log(f"  [{label}] one step of 8 rows at lengths {ragged}, kernel vs plain: logits "
            f"max_abs_err/max|ref| {rel:.3e} (tol {tol:g}), cache max_abs_err {cerr:.3e}; "
            f"greedy ids agree on {agree}/8 rows")
    del params, base, pool
    cfg16 = ModelConfig(**{**LLAMA3_8B, "num_layers": 2, "dtype": "float16"})
    params = llama.init_qparams(cfg16, QuantConfig(w_bit=4, group_size=G),
                                torch.Generator(device="cuda").manual_seed(2))
    params = llama.fuse_linears(llama.quantize_head(params, cfg16), cfg16)
    run_forward("stacked_f16", params, cfg16, "1", 100,
                ("w4a16_gemv", "w4a16_gemm", "flash_decode", "flash_prefill"), torch.float16)
    set_config(None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder layers of the W4 model of phases 3-3d and the W3 "
                         "model of phase 3e (width is Llama-3-8B's)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    def stamp(msg: str) -> None:      # a phase's first line, with the seconds so far
        log(f"[{time.perf_counter() - t_start:.1f} s] {msg}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from awq_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    stamp(f"phase 1: build")
    t0 = time.perf_counter()
    took = _build.build_all()
    log(f"  nvcc ({_build.ARCH}): " + ", ".join(f"{k} {v:.1f} s" for k, v in took.items())
        + f"; wall {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        fn = "?"      # the entry function (mangled: IaLb0E is <int8_t, false>)
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name} {fn}: {line.strip()}")

    stamp(f"phase 2: kernels against their plain versions (main-path shapes)")
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = Timer(torch, reps=20)
    cases = []
    phase_kernels(torch, timer, cases)
    torch.cuda.empty_cache()
    phase_megakernels(torch, timer, cases)
    torch.cuda.empty_cache()
    phase_megakernels(torch, timer, cases, w3=True)
    torch.cuda.empty_cache()
    phase_int8_kernels(torch, timer, cases)
    phase_fused_append(torch, cases)
    phase_f16_attention(torch, timer, cases)
    phase_int8_prefill_kernels(torch, timer, cases)
    t_tp = time.perf_counter()
    phase_tp_kernels(torch, timer, cases)
    log(f"  the tensor-parallel halves: {time.perf_counter() - t_tp:.1f} s")
    phase_layer_attention(torch, timer, cases)
    t_alibi = time.perf_counter()
    phase_alibi_attention(torch, timer, cases)
    torch.cuda.empty_cache()
    t_fam = time.perf_counter()
    phase_family_attention(torch, timer, cases)
    log(f"  the families' batched, paged and int8 modes: {time.perf_counter() - t_fam:.1f} s")
    t_new = time.perf_counter()
    phase_new_family_attention(torch, timer, cases)
    log(f"  StarCoder's group, OPT-6.7B's heads and the device-length split: "
        f"{time.perf_counter() - t_new:.1f} s")
    t_ver = time.perf_counter()
    phase_verify_attention(torch, timer, cases)
    log(f"  the window mode of K2 and K9 (the batched verify): "
        f"{time.perf_counter() - t_ver:.1f} s")
    torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    phase_mpt_megakernels(torch, timer, cases)
    log(f"  the ALiBi modes and K4's MPT shape: {time.perf_counter() - t_alibi:.1f} s")
    del timer
    torch.cuda.empty_cache()

    stamp(f"phase 3: serve four requests, Llama-3-8B width, {args.layers} layers, "
        "on the megakernels and on the stacked path")
    launches, cfg, params, single_ids, single_peak, single_ttft = phase_serve(torch,
                                                                              args.layers)
    w4 = dict(weight_bytes=weight_bytes(params), single_peak=single_peak)

    stamp(f"phase 3i: phase 3's model through a checkpoint and the worker, {args.layers} layers: "
          "saved and loaded by the port, served by ModelWorker over HTTP, and the four requests "
          "on the graph-replayed and the eager decode")
    launches.update(phase_serve_checkpoint(torch, args.layers, single_ids))

    stamp(f"phase 3b: serve twelve requests through an 8-slot BatchEngine, {args.layers} "
        "layers, on the batched megakernel and on the stacked batched path")
    batched, ids, peaks = phase_serve_batched(torch, cfg, params)
    launches.update(batched)
    slot_ids = ids["batched"]

    stamp(f"phase 3c: the same twelve requests through an 8-slot PagedBatchEngine, "
        f"{args.layers} layers, pages of {PAGE}, on K6's paged mode and on the stacked "
        "paged path, with the default pool and with a pool that preempts")
    launches.update(phase_serve_paged(torch, cfg, params, slot_ids))

    stamp(f"phase 3d: the int8 KV cache, {args.layers} layers: phase 3's four requests "
        "through InferenceEngine(cache_dtype='int8') and phase 3b's twelve through an "
        "8-slot BatchEngine(cache_dtype='int8'), on the megakernels and on the stacked path")
    int8_launches, int8_slot_ids = phase_serve_int8(torch, cfg, params, single_ids, slot_ids,
                                                    peaks["batched"])
    launches.update(int8_launches)

    stamp(f"phase 3m: speculative decoding, {args.layers} layers: four requests whose prompts "
          "repeat a random 16-gram through InferenceEngine.generate_speculative(k=7) (the host "
          "loop, K5 over each window; and device_loop=True), then phase 3b's twelve through "
          "an 8-slot BatchEngine(spec_k=7) over a bf16 and an int8 cache (the window mode of "
          "K2 and K9 a layer) and a sampled run")
    launches.update(phase_serve_spec(torch, cfg, params, slot_ids, int8_slot_ids))

    stamp(f"phase 3f: the int8-activation prefill, {args.layers} layers: phase 3's four "
        "requests and phase 3b's twelve with RuntimeConfig(prefill_w8=True) (K11) and with "
        "prefill_a8 alone (K10), and the twelve through a PagedBatchEngine with the cache")
    launches.update(phase_serve_int8_prefill(torch, cfg, params, dict(
        single_ids=single_ids, single_ttft=single_ttft, single_peak=single_peak,
        slot_ids=slot_ids, slot_peak=peaks["batched"])))
    del params
    torch.cuda.empty_cache()

    stamp(f"phase 3e: the W3 model (pack_int3 weights and head), {args.layers} layers: "
        "phase 3's four requests through InferenceEngine and phase 3b's twelve through an "
        "8-slot BatchEngine, on the megakernels' W3 modes and on K1's; then the twelve on "
        "K6's int8 and paged W3 modes")
    w4["slot_peak"] = peaks["batched"]
    launches.update(phase_serve_w3(torch, args.layers, w4, single_ids, slot_ids))

    stamp(f"phase 3g: tensor-parallel serving, {args.layers} layers: phase 3's four requests "
          "through InferenceEngine(RuntimeConfig(mesh=...)), (a) at tp = 1 over NCCL with a "
          "bf16 and an int8 cache, (b) at tp = 2 over gloo, two ranks sharing the card")
    tp_launches, mesh, tp1_ids = phase_serve_tp(torch, args.layers, single_ids)
    launches.update(tp_launches)
    tp2_layers = min(TP2_LAYERS, args.layers)
    stamp(f"phase 3g (b): tp = 2 over gloo, {tp2_layers} layers")
    same = tp2_layers == args.layers
    launches["tp2"] = phase_serve_tp2(torch, tp2_layers, tp1_ids if same else None,
                                      single_ids if same else None)

    stamp(f"phase 3h: Falcon-7B, {FALCON_7B['num_layers']} layers at full width, W4-g{FALCON_G}: "
          "phase 3's four requests through InferenceEngine on the stacked path (K14, K3 hd 64)")
    launches.update(phase_serve_falcon(torch, FALCON_7B["num_layers"]))

    stamp(f"phase 3j: MPT-7B, {MPT_7B['num_layers']} layers at full width, W4-g{G}: phase 3's "
          "four requests through InferenceEngine on K4's MPT shape and on the stacked path "
          "(K2, K3 with slopes), under the graph, then through ModelWorker")
    launches.update(phase_serve_mpt(torch, MPT_7B["num_layers"]))

    stamp(f"phase 3k: Falcon-7B and MPT-7B, {FAMILY_LAYERS} layers at full width: phase 3b's "
          "twelve requests through an 8-slot BatchEngine over a bf16 and an int8 cache and "
          f"through a PagedBatchEngine with pages of {PAGE} (K2, K9, K8 at head_dim 64 and "
          "wide groups, or with ALiBi slopes)")
    launches.update(phase_serve_families_batched(torch, FAMILY_LAYERS))

    stamp("phase 3l: OPT-6.7B, StarCoder and Pythia-6.9B at full width and depth, W4-g128: "
          "phase 3's four requests through InferenceEngine under the graph (K2 or K14 split by "
          f"the length read), then phase 3b's twelve through an 8-slot BatchEngine at "
          f"{NEW_FAMILY_BATCH_LAYERS} layers (StarCoder also over an int8 cache and through a "
          "PagedBatchEngine)")
    launches.update(phase_serve_new_families(torch, NEW_FAMILY_BATCH_LAYERS))

    stamp(f"phase 4: forward, kernel path against plain path (2 layers)")
    phase_model_parity(torch)
    phase_model_parity_w3_f16(torch)
    phase_model_parity_falcon(torch)
    launches.update(phase_model_parity_alibi(torch))
    phase_model_parity_families_batched(torch)
    launches.update(phase_model_parity_new_families(torch))
    phase_model_parity_tp(torch, mesh)
    import torch.distributed as dist

    dist.destroy_process_group()

    sources = {"w4a16_gemv": ("awq_tpu_torch/csrc/w4a16.cuh",
                              "awq_tpu/ops/w4a16.py:388"),
               "w4a16_gemm": ("awq_tpu_torch/csrc/w4a16.cuh",
                              "awq_tpu/ops/w4a16.py:388"),
               "w3a16_gemv": ("awq_tpu_torch/csrc/w4a16.cuh",
                              "awq_tpu/ops/w4a16.py:310"),
               "w3a16_gemm": ("awq_tpu_torch/csrc/w4a16.cuh",
                              "awq_tpu/ops/w4a16.py:310"),
               "flash_decode": ("awq_tpu_torch/csrc/decode_attn.cu",
                                "awq_tpu/ops/decode_attn.py:394"),
               "flash_prefill": ("awq_tpu_torch/csrc/decode_attn.cu",
                                 "awq_tpu/ops/decode_attn.py:691"),
               "megakernel_token": ("awq_tpu_torch/csrc/megakernel.cu",
                                    "awq_tpu/ops/megakernel.py:1047"),
               "megakernel_layer": ("awq_tpu_torch/csrc/megakernel.cu",
                                    "awq_tpu/ops/megakernel.py:954"),
               "megakernel_chunk": ("awq_tpu_torch/csrc/megakernel_batched.cu",
                                    "awq_tpu/ops/megakernel_chunk.py:295"),
               "megakernel_batched": ("awq_tpu_torch/csrc/megakernel_batched.cu",
                                      "awq_tpu/ops/megakernel_batched.py:531"),
               "cache_append": ("awq_tpu_torch/csrc/cache_append.cu",
                                "awq_tpu/ops/cache_append.py:62"),
               "flash_decode_paged": ("awq_tpu_torch/csrc/decode_attn.cu",
                                      "awq_tpu/ops/decode_attn.py:944"),
               "megakernel_batched_paged": ("awq_tpu_torch/csrc/megakernel_batched.cu",
                                            "awq_tpu/ops/megakernel_batched.py:531"),
               "cache_append_paged": ("awq_tpu_torch/csrc/cache_append.cu",
                                      "awq_tpu/models/llama.py:1729"),
               "flash_decode_int8": ("awq_tpu_torch/csrc/decode_attn.cu",
                                     "awq_tpu/ops/decode_attn.py:325"),
               "megakernel_token_int8": ("awq_tpu_torch/csrc/megakernel.cu",
                                         "awq_tpu/ops/megakernel.py:1047"),
               "megakernel_batched_int8": ("awq_tpu_torch/csrc/megakernel_batched.cu",
                                           "awq_tpu/ops/megakernel_batched.py:531"),
               "cache_append_int8": ("awq_tpu_torch/csrc/cache_append.cu",
                                     "awq_tpu/models/llama.py:1313"),
               "megakernel_token_w3": ("awq_tpu_torch/csrc/megakernel.cu",
                                       "awq_tpu/ops/megakernel.py:1047"),
               "megakernel_layer_w3": ("awq_tpu_torch/csrc/megakernel.cu",
                                       "awq_tpu/ops/megakernel.py:954"),
               "megakernel_chunk_w3": ("awq_tpu_torch/csrc/megakernel_batched.cu",
                                       "awq_tpu/ops/megakernel_chunk.py:295"),
               "megakernel_batched_w3": ("awq_tpu_torch/csrc/megakernel_batched.cu",
                                         "awq_tpu/ops/megakernel_batched.py:531"),
               "megakernel_batched_int8_w3": ("awq_tpu_torch/csrc/megakernel_batched.cu",
                                              "awq_tpu/ops/megakernel_batched.py:531"),
               "megakernel_batched_paged_w3": ("awq_tpu_torch/csrc/megakernel_batched.cu",
                                               "awq_tpu/ops/megakernel_batched.py:531"),
               "w8a8_gemm": ("awq_tpu_torch/csrc/w8a8.cu", "awq_tpu/ops/w4a16.py:1302"),
               "w4a8_gemm": ("awq_tpu_torch/csrc/w8a8.cu", "awq_tpu/ops/w4a16.py:1046"),
               # XLA in the JAX package, not Pallas: no TPU kernel to replace
               "quant_per_token": ("awq_tpu_torch/csrc/w8a8.cu", "awq_tpu/ops/w8a8.py:33"),
               "megakernel_attn_half": ("awq_tpu_torch/csrc/megakernel.cu",
                                        "awq_tpu/ops/megakernel_tp.py:126"),
               "megakernel_mlp_half": ("awq_tpu_torch/csrc/megakernel.cu",
                                       "awq_tpu/ops/megakernel_tp.py:235"),
               "flash_decode_layer": ("awq_tpu_torch/csrc/decode_attn.cu",
                                      "awq_tpu/ops/decode_attn.py:803"),
               "flash_prefill_hd64": ("awq_tpu_torch/csrc/decode_attn.cu",
                                      "awq_tpu/ops/decode_attn.py:691"),
               "flash_decode_alibi": ("awq_tpu_torch/csrc/decode_attn.cu",
                                      "awq_tpu/ops/decode_attn.py:394"),
               "flash_prefill_alibi": ("awq_tpu_torch/csrc/decode_attn.cu",
                                       "awq_tpu/ops/decode_attn.py:691"),
               "flash_decode_layer_alibi": ("awq_tpu_torch/csrc/decode_attn.cu",
                                            "awq_tpu/ops/decode_attn.py:803"),
               "megakernel_token_mpt": ("awq_tpu_torch/csrc/megakernel.cu",
                                        "awq_tpu/ops/megakernel.py:1047"),
               "megakernel_layer_mpt": ("awq_tpu_torch/csrc/megakernel.cu",
                                        "awq_tpu/ops/megakernel.py:954"),
               "megakernel_token_mpt_w3": ("awq_tpu_torch/csrc/megakernel.cu",
                                           "awq_tpu/ops/megakernel.py:1047"),
               "megakernel_layer_mpt_w3": ("awq_tpu_torch/csrc/megakernel.cu",
                                           "awq_tpu/ops/megakernel.py:954"),
               "flash_decode_wide": ("awq_tpu_torch/csrc/decode_attn.cu",
                                     "awq_tpu/ops/decode_attn.py:394"),
               "flash_decode_paged_wide": ("awq_tpu_torch/csrc/decode_attn.cu",
                                           "awq_tpu/ops/decode_attn.py:944"),
               "flash_decode_int8_wide": ("awq_tpu_torch/csrc/decode_attn.cu",
                                          "awq_tpu/ops/decode_attn.py:325"),
               "flash_decode_paged_alibi": ("awq_tpu_torch/csrc/decode_attn.cu",
                                            "awq_tpu/ops/decode_attn.py:944"),
               "flash_decode_int8_alibi": ("awq_tpu_torch/csrc/decode_attn.cu",
                                           "awq_tpu/ops/decode_attn.py:325"),
               "cache_append_int8_hd64": ("awq_tpu_torch/csrc/cache_append.cu",
                                          "awq_tpu/models/llama.py:1313"),
               "flash_decode_opt": ("awq_tpu_torch/csrc/decode_attn.cu",
                                    "awq_tpu/ops/decode_attn.py:394"),
               "flash_decode_layer_starcoder": ("awq_tpu_torch/csrc/decode_attn.cu",
                                                "awq_tpu/ops/decode_attn.py:803"),
               "flash_prefill_starcoder": ("awq_tpu_torch/csrc/decode_attn.cu",
                                           "awq_tpu/ops/decode_attn.py:691"),
               "flash_decode_wide_starcoder": ("awq_tpu_torch/csrc/decode_attn.cu",
                                               "awq_tpu/ops/decode_attn.py:394"),
               "flash_decode_paged_wide_starcoder": ("awq_tpu_torch/csrc/decode_attn.cu",
                                                     "awq_tpu/ops/decode_attn.py:944"),
               "flash_decode_int8_wide_starcoder": ("awq_tpu_torch/csrc/decode_attn.cu",
                                                    "awq_tpu/ops/decode_attn.py:325"),
               # XLA in the JAX package (verify_step_batched's xla_attn), not
               # Pallas: no TPU kernel to replace
               "flash_verify": ("awq_tpu_torch/csrc/decode_attn.cu",
                                "awq_tpu/models/llama.py:1407"),
               "flash_verify_int8": ("awq_tpu_torch/csrc/decode_attn.cu",
                                     "awq_tpu/models/llama.py:1407")}
    # one representative shape per kernel in the summary; every case is
    # printed above
    pick = {"w4a16_gemv": "wgateup M=1 ", "w4a16_gemm": "wgateup M=1000",
            "flash_decode": "len=4000", "flash_prefill": "S=512 start=700",
            "megakernel_token": "32 layers", "megakernel_layer": "layer 5 len=1000",
            "megakernel_chunk": "32 layers S=32 hist=700",
            "megakernel_batched": "32 layers + W4 head, B=8", "cache_append": "B=8 ragged",
            "flash_decode_paged": "B=8", "megakernel_batched_paged": "32 layers + W4 head, B=8",
            "cache_append_paged": "B=8", "flash_decode_int8": "len=4000",
            "megakernel_token_int8": "32 layers",
            "megakernel_batched_int8": "32 layers + W4 head, B=8",
            "cache_append_int8": "B=8 ragged",
            "w3a16_gemv": "wgateup M=1 ", "w3a16_gemm": "wgateup M=1000",
            "megakernel_token_w3": "32 layers", "megakernel_layer_w3": "layer 5 len=1000",
            "megakernel_chunk_w3": "32 layers S=32 hist=700",
            "megakernel_batched_w3": "32 layers + W3 head, B=8",
            "megakernel_batched_int8_w3": "32 layers + W3 head, B=8",
            "megakernel_batched_paged_w3": "32 layers + W3 head, B=8",
            "w8a8_gemm": "wgateup M=1000", "w4a8_gemm": "wgateup M=1000",
            "quant_per_token": "M=1000 IC=4096",
            "megakernel_attn_half": "tp=2 layer 5 len=1000", "megakernel_mlp_half": "tp=2 ",
            "flash_decode_layer": "len=1000 B=1 nq=71", "flash_prefill_hd64": "S=512 start=700",
            "flash_decode_alibi": "len=4000", "flash_prefill_alibi": "S=512 start=700 nq=32 nkv=32 bf",
            "flash_decode_layer_alibi": "len=1000 B=1 nq=16",
            "megakernel_token_mpt": "32 layers", "megakernel_layer_mpt": "layer 5 len=1000",
            "megakernel_token_mpt_w3": "32 layers", "megakernel_layer_mpt_w3": "layer 5 len=1000",
            "flash_decode_wide": "Falcon-7B", "flash_decode_paged_wide": "Falcon-7B",
            "flash_decode_int8_wide": "Falcon-7B", "flash_decode_paged_alibi": "MPT-7B",
            "flash_decode_int8_alibi": "MPT-7B", "cache_append_int8_hd64": "Falcon-7B",
            "flash_decode_opt": "OPT-6.7B", "flash_decode_layer_starcoder": "StarCoder nq=48 "
            "nkv=1 hd=128 B=1 len=1000", "flash_prefill_starcoder": "S=512 start=700",
            "flash_decode_wide_starcoder": "StarCoder", "flash_decode_paged_wide_starcoder":
            "StarCoder", "flash_decode_int8_wide_starcoder": "StarCoder",
            "flash_verify": f"W={VERIFY_W} B=8 ragged len 0..1200 Llama-3-8B",
            "flash_verify_int8": f"W={VERIFY_W} B=8 ragged len 0..1200 Llama-3-8B"}
    # launches: each kernel's count on its own path's main run in phases 3,
    # 3b and 3c; on the single-stream paths, whose decode replays a captured
    # step, the count of its symbol in that run's device trace (serve_single)
    # (the stacked path carries K1-K3, the megakernels K4-K5, the
    # batched engine K6, its stacked path the appends fused into K2 (K7's
    # counter), the paged engine K6's paged mode and, stacked, K8 and its
    # appends, with the default pool; phase 3d's int8 runs K4's
    # and K6's int8 modes, and on the stacked paths K9 and its int8 appends;
    # phase 3h's falcon run K14 and K3's head_dim-64 mode; phase 3j's MPT-7B
    # runs K4's MPT shape and K3 with slopes, its stacked run K2 with slopes;
    # K14 with slopes counts on phase 4's BLOOM run, the one path that takes
    # it; K4's MPT W3 units and layer entry serve no request: 0).
    # forward calls K4's token entry; the layer entry is the same kernel over
    # one layer and has no caller on the main path, so it counts 0 there.
    runs = {"megakernel_batched": "batched", "cache_append": "batched_stacked",
            "megakernel_batched_paged": "paged", "flash_decode_paged": "paged_stacked",
            "cache_append_paged": "paged_stacked", "flash_decode_int8": "stacked_int8",
            "megakernel_token_int8": "megakernels_int8",
            "megakernel_batched_int8": "batched_int8",
            "cache_append_int8": "batched_stacked_int8",
            "w3a16_gemv": "stacked_w3", "w3a16_gemm": "stacked_w3",
            "megakernel_token_w3": "megakernels_w3", "megakernel_layer_w3": "megakernels_w3",
            "megakernel_chunk_w3": "megakernels_w3", "megakernel_batched_w3": "batched_w3",
            "megakernel_batched_int8_w3": "batched_int8_w3",
            "megakernel_batched_paged_w3": "paged_w3",
            "w8a8_gemm": "prefill_w8", "w4a8_gemm": "prefill_a8",
            "quant_per_token": "prefill_w8",
            "megakernel_attn_half": "tp1", "megakernel_mlp_half": "tp1",
            "flash_decode_layer": "falcon", "flash_prefill_hd64": "falcon",
            "flash_decode_alibi": "mpt_stacked", "flash_prefill_alibi": "mpt",
            "flash_decode_layer_alibi": "bloom", "megakernel_token_mpt": "mpt",
            "megakernel_layer_mpt": "mpt", "megakernel_token_mpt_w3": "mpt",
            "megakernel_layer_mpt_w3": "mpt", "flash_decode_wide": "falcon_batched",
            "flash_decode_paged_wide": "falcon_paged",
            "flash_decode_int8_wide": "falcon_batched_int8",
            "flash_decode_paged_alibi": "mpt_paged", "flash_decode_int8_alibi": "mpt_batched_int8",
            "cache_append_int8_hd64": "falcon_batched_int8",
            # phase 3l: OPT-6.7B's single stream (K2 on the graph), StarCoder's
            # (K14, K3) and its 8-slot runs
            "flash_decode_opt": "opt", "flash_decode_layer_starcoder": "starcoder",
            "flash_prefill_starcoder": "starcoder",
            "flash_decode_wide_starcoder": "starcoder_batched",
            "flash_decode_paged_wide_starcoder": "starcoder_paged",
            "flash_decode_int8_wide_starcoder": "starcoder_batched_int8",
            # phase 3m: the 8-slot BatchEngine(spec_k=7) over bf16 and int8
            "flash_verify": "spec", "flash_verify_int8": "spec_int8"}
    # K3's head_dim-64 mode counts under K3's one wrapper, K7's int8 mode at
    # head_dim 64 under K7's int8 wrapper
    counter = {"flash_prefill_hd64": "flash_prefill", "cache_append_int8_hd64": "cache_append_int8",
               **{k: k.replace("_starcoder", "").replace("_opt", "")
                  for k in runs if k.endswith(("_starcoder", "_opt"))}}
    kernels = []
    for name, (src, replaces) in sources.items():
        run = runs.get(name, "megakernels" if name.startswith("megakernel") else "stacked")
        extra = {}
        if counter.get(name, name) in FUSED_APPEND:
            # K7's appends on the path are fused into the attention's launches:
            # their launches count under K7's names, beside the time and bound
            # of one such launch (attention and append of one layer) at the
            # batched step's shape; the standalone K7, off the path, stands
            # beside as the reference its appends are held to
            k7 = next(c for c in cases if c["name"] == name and c["shape"].startswith("L=32"))
            c = next(x for a in FUSED_APPEND[counter.get(name, name)] for x in cases
                     if x["name"] == a and x["shape"].startswith(pick[name]))
            src = "awq_tpu_torch/csrc/decode_attn.cu"
            extra = dict(fused_into=c["name"], standalone=dict(
                source=sources[name][0], launches=0, shape=k7["shape"], ms=k7["ms"],
                plain_ms=k7["plain_ms"], bound_ms=k7["bound_ms"], library_ms=k7["library_ms"]))
        else:
            c = next(c for c in cases if c["name"] == name and c["shape"].startswith(pick[name]))
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[run][counter.get(name, name)], max_abs_err=c["max_abs_err"],
            ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"], shape=c["shape"], **extra,
            **{k: c[k] for k in ("yardstick_ms", "yardstick", "composition_ms", "composition")
               if k in c}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
