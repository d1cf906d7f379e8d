"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each printing its own lines and seconds:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel of the port from src/ (set-up), and print
     each kernel function's registers, shared memory and spills from the
     ptxas report and its tensor-core instructions (HMMA, HGMMA) from
     cuobjdump's SASS;
  3. set-up of the engine: TPC-H SF 1 (seed 7) in 64 MiB base objects;
  4. kernel phase: partition_pack (CUDA) against its plain PyTorch version
     on the card, exactly (atol 0 on buf, counts and slots), at the Pallas
     kernel test's shapes, at the card tests' edges (1 to 8192 partitions,
     a hot key, T around a tile, capacity 0 and below the largest count,
     ids out of range, 2-, 4- and 8-byte groups in one call) and at the
     main path's (rows of the largest lineitem split, q12 scan_li's int64
     and int32 column groups, 8 / 64 / 1024 partitions), with kernel
     (warm), plain and library times and the memory bound; at the main
     shapes also the cold time (L2 flushed by an 80 MB write before each
     call, outside its events), the device time by torch.profiler (warm
     and cold) and the device operations of one call (two partition_pack
     kernels up to 64 partitions, three above: the multi-pass route); then
     pack_by_key (hash, counts and pack; one host sync) at 8 partitions
     against partition_ids and the plain pack, and op_partition's host
     syncs and device operations;
  5. query phase: q1, q3, q5, q6, q12, q12 (multi-stage shuffle) and q14
     through the port's engine on the card, each held against the
     single-threaded oracle run on the CPU through the plain versions;
     partition_pack must have launched in q3, q5, q12 and q14;
  6. structural parity: q3 and q12 at compute_scale=0 on cuda and on cpu
     give identical latency, cost, GETs, PUTs and task counts;
  6a. workload: the SF 1 engine behind Session.from_coordinator runs a
     24-query TPC-H mix (Poisson, virtual mean 5 s) through run_mix:
     p50/p99, $ per query, wall, the Fig-7 break-even; partition_pack
     must launch, no serve kernel may, every record finite;
  6b. workload parity: the same mix and an exact two-tenant fleet (a
     foreground quota, a background tenant under admission="reject") on
     cuda and on cpu at SF 0.05, compute_scale=0: equal exactly;
  6c. failover: q12 and q3 killed halfway on the SF 1 store at
     compute_scale=0: the replay passes the store's immutability audit,
     latency and cost equal a run with no kill, rows equal the oracle;
  6d. trace: q12 and q3 through Session(trace=True, metrics=True) equal
     the untraced run; the Chrome export round-trips;
  6e. planner: pareto_search for q12 over 6 configs on cuda and on cpu
     at SF 0.05: equal frontiers;
  7. ssd kernel phase: ssd_scan (CUDA) against its plain version
     (ssd_chunked) on the card at the Pallas kernel test's CASES, the
     smoke config's chunk, a sequence shorter than its chunk and the serve
     path's main shape, y and state within rtol = atol = 2e-4 in f32 (and,
     at the main shape in bf16, y within one bf16 step), with kernel,
     plain and bound times at the main shape (the bound at the f32 pipes'
     rate and, beside it, at the 3xTF32 rate the kernels compute at); then
     granite-4.0-h-small's prefill cell in bf16 (128 heads of 64, state
     128, chunk 128, 2 x 16,384 and 8 x 4096) with dt drawn small, so that
     the state carries across chunks (checked: y without the inter-chunk
     pass lies outside the tolerance);
  8. serve phase: the serve cell of launch/serve (mamba2-2.7b at full
     width and depth, 64 layers, random weights and prompts from
     serve.random_request, drawn in f32). While only the f32 tree is on
     the card: the f32 answer (prefill of the cell's prompts) and the
     prompt of one sequence replayed through decode in f32 within the
     reference test's 2e-3. Then the tree is cast to bf16 in place, leaf
     by leaf, and 4 prompts of 512 tokens and 32 new tokens go through
     launch/serve.generate after a short warm-up request: prefill s,
     decode ms a step, tokens/s, peak memory (and the f32 part's and the
     cast's); ssd_scan must launch once a layer (64) in the prefill and
     nothing else may launch; every logit finite; the prompt replayed
     through decode gives the prefill's last logits, in bf16 as near to
     the f32 answer as the bf16 prefill is;
  9. serve parity phase: the same config at 4 layers, one 256-token
     prompt, prefill on the card (kernel) against prefill on the CPU
     (plain versions) on identical weights, in f32 (1e-3) and in bf16
     (5 % relative L2, the tolerance the CPU tests hold the port's bf16
     to against the reference);
 10. flash kernel phase: flash_gqa (CUDA) against its plain version
     (attention_ref over k/v gathered by the kv-head map) on the card at
     the Pallas kernel test's CASES, smollm-135m's padded-head map and the
     dense serve path's main shape (B=4, S=512, 32 q heads over 2 kv
     heads, D 128, causal), MLA's prefill pair (q/k 192, v 128) at a
     ragged windowed shape and at deepseek-v2-lite's prefill (B=4, S=512,
     16 heads), recurrentgemma-9b's head dim 256 (16 q heads over 1, B=4,
     S=512, causal; and B=1, S=4096, window 2048) and whisper-tiny's
     shapes (6 heads of 64, no mask: cross attention of 64 and of 1 query
     against 1500 frames, the encoder's 1500 x 1500) and smollm-135m's
     train shape (B=4, S=512, 16 padded q heads over 4 kv heads of 64,
     causal) and granite-4.0-h-small's NoPE prefill (B=2, S=4096, 32 q
     heads over 8 kv heads of 128, causal) at its softmax scale of 1/128,
     within 2e-5 in f32 and 2e-2 in bf16, with kernel, plain,
     library (scaled_dot_product_attention with enable_gqa, a window as
     an explicit mask, k and v expanded beforehand under a padded head
     map, timed as a yardstick only, and the kernels it ran, which name
     its backend) and bound times at every main shape; each record names
     the body that ran (wgmma in bf16 at (64, 64), (192, 128) and (256,
     256), with its kv splits where it has no mask: the encoder's items
     past its first wave of blocks and the cross attention of 64 queries
     and of one split; split for the one-query cross attention in f32; mma
     for bf16 at (16, 16), (32, 32) and (128, 128); fma for f32), held
     against the CUDA functions a CUDA graph of the call holds, as the
     driver recorded them, and those the source's dispatch says it
     launched (the kernels line lists each body's); with no mask q is
     drawn at 3 times the unit scale, so that the outputs are O(1), and
     every case checks that its tolerance fails an output 10 % off;
 10a. grad: a dense smoke layer's wq/wk/wv gradients through flash_gqa
     (one launch forward, none backward) against the CPU's, f32;
 11. dense serve phase, after the Mamba weights are released: the serve
     cell glm4-9b at full width and depth (40 layers, 9.4 B parameters),
     as in phase 8: flash_gqa must launch once a layer (40) in the prefill
     and 0 attention calls routed to the plain path; replay vs prefill in
     bf16 against the f32 answer and in f32 (one 128-token prompt) within
     2e-3;
 12. dense parity phase: glm4-9b at 2 layers and full width, one
     128-token prompt, card prefill against CPU prefill in f32 (1e-3) and
     bf16 (5 % relative L2), and smollm-135m at full depth (30 layers, its
     9/3 heads padded to 16/4) the same way in f32, so that the padded
     kv-head map runs on the card at a real width;
 13. moe dispatch: models/moe.dispatch (one partition_pack call over B·E
     = 256 ids) at the deepseek serve cell's prefill (4 x 512 tokens, top
     6 of 64 experts, capacity 72) and decode (4 tokens, capacity 8)
     shapes against the plain per-group dispatch_indices, every slot and
     drop bit for bit, the buffer against the plain pack exactly, and no
     host sync; its time against B calls of 64 partitions, the plain
     version, a stable sort and gather, and the memory bound; then the
     expert share of granite-4.0-h-small's cell (top 10 of 72, experts
     0-35 held): ids of -1 for the entries not held over B x 36
     partitions at 8 x 4096 and 2 x 16,384, kernel vs plain exactly, and
     the dispatch's slots (an entry not held dropped); then the MoE
     combine (moe_combine, one CUDA kernel a call) at the two MoE cells'
     shapes in bf16 (deepseek-v2-lite-16b 4 x 4096, top 6 of 64, d 2048;
     granite-4.0-h-small 8 x 4096, top 10 of 72 with 36 held, d 4096),
     ids and slots from the dispatch: the kernel's documented order in
     plain PyTorch bit for bit, the plain combine within one bf16 step at
     the terms' scale,
     one launch and one CUDA kernel a call (a CUDA graph of the call);
     its time (events), its bytes bound and share, the plain combine's
     time;
 14. moe serve phase: the serve cell deepseek-v2-lite-16b at full width
     and depth (27 layers, 15.7 B parameters drawn in f32 and cast in
     place to bf16), as in phase 8: flash_gqa must launch
     once a layer (27) in the prefill with 0 routed calls, and
     partition_pack and moe_combine once a MoE layer (26) in the prefill
     and in every decode step;
 15. moe parity phase: deepseek-v2-lite-16b at full width and 3 layers
     (the dense layer 0 and two MoE layers), one 128-token prompt, card
     prefill against CPU prefill in f32 (1e-3) and bf16 (5 % relative
     L2), with the count of tokens whose experts differ between the two;
 16. griffin serve phase: the serve cell recurrentgemma-9b at full width
     and depth (38 layers, 10.4 B parameters drawn in f32), as in phase 8:
     flash_gqa at head dim 256 once an attention layer (12) in the
     prefill, none in decode, 0 routed; then its parity phase: the smoke
     config (window 8) card vs CPU over a 64-token prompt (f32 1e-3, bf16
     5 %), and the f32 replay of 16 tokens on the card within 2e-3 of the
     prefill (the window's ring wraps);
 17. whisper serve phase: the serve cell whisper-tiny at its published
     size (4 + 4 layers, 1500 frames drawn after the prompts), 64 prompt
     tokens and 32 new, as in phase 8: flash_gqa 12 a prefill (4 encoder,
     4 self, 4 cross) and 8 each decode step (the frames encoded again,
     and cross attention of one query); then its smoke config card vs CPU;
 18. llama4 serve phase: the serve cell llama4-maverick-400b-a17b at full
     width and 4 of 48 layers (one super-block; 35.3 B parameters drawn in
     bf16, 70.7 GB, no f32 tree): flash_gqa 4 a prefill, partition_pack 2
     a prefill and 2 each decode step, 0 routed; finite logits, tokens in
     range, the bf16 replay within 0.25 relative L2 of the bf16 prefill
     with no drops; its peak memory; then its smoke config card vs CPU,
     with the tokens routed to other experts counted.
 19. train parity: one train step's loss and gradients of smollm-135m at
     full width and depth in f32 (2 x 256 tokens) on the card against the
     CPU's, loss 1e-5 relative, every gradient leaf finite, nonzero and
     within GRAD_TOL of its largest entry, flash_gqa launched as
     ``train_launches`` (launch/steps.py) works out, 0 routed.
 20. train phases, after the serve weights are released: mamba2-2.7b at
     full width and depth (64 layers, 2.70 B parameters), smollm-135m (30
     layers, 9 q heads over 3 kv heads of 64, tied embeddings) and
     deepseek-v2-lite-16b at full width and 3 layers (MLA at (192, 128),
     2 MoE layers), each in f32 parameters with bf16 compute and AdamW at
     lr 1e-3 (launch/steps.make_train_step, remat "full"), 4 steps on one
     batch of 4 x 512 tokens drawn from the seed: the loss finite at every
     step and lower at the 4th than at the 1st, the first step's gradient
     (AdamW's first moment) finite and nonzero in every leaf, every
     parameter leaf moved, each kernel launched exactly as
     ``train_launches`` works out
     (twice a layer body that remat recomputes, once outside one; the
     backward recomputes the plain versions and launches nothing), 0
     routed calls; ms a step (host clock, synchronized; steps 2 and 3),
     tokens/s, peak memory, and the 4th step's device time by
     torch.profiler (busy, idle share, each kernel's ms).
 21. elastic phases: runtime/train_loop.ElasticTrainer on the card,
     smollm-135m at full width and depth and mamba2-2.7b at full width and
     4 layers, f32 parameters, bf16 compute, AdamW at lr 1e-3, 8 steps in
     tasks of 2 on SyntheticCorpus batches of 4 x 512 tokens, checkpoints
     of 4 shards in the host's object store: a clean run, a run whose
     workers die at (task 1, step 3) and (task 2, step 4), each over its
     own store (the first freed before the second), then a third trainer
     over the finished store. The committed steps [2, 4, 6, 8] in both
     runs, the losses finite and equal at rtol 0, atol 0, each kernel
     launched ``train_launches`` times a step the run ran (8 and 9 steps),
     0 routed, the last checkpoint restored on the CPU equal bit for bit
     to the state the card saved, the third trainer committing nothing;
     ms a step inside the trainer, each save's and restore's seconds and
     virtual end, the checkpoint's bytes, the store's PUTs and GETs, the
     host's peak RSS and the phase's seconds.
Each path runs with every launch count set to 0 just before it and read
just after; each phase prints its seconds and its peak device memory. It
then prints the kernels line and, last, the device line. Any failure exits
non-zero before the last line; without a card it exits 2 at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.core.coordinator import Coordinator  # noqa: E402
from repro_torch.core.engine import make_engine, oracle, run_query  # noqa
from repro_torch.core.session import QuerySpec, Session  # noqa: E402
from repro_torch.faults.journal import Journal  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._graph import launched_functions  # noqa: E402
from repro_torch.kernels.flash_gqa import flash_gqa as FK  # noqa: E402
from repro_torch.kernels.flash_gqa import ops as FLASH_OPS  # noqa: E402
from repro_torch.kernels.flash_gqa.ref import attention_ref  # noqa: E402
from repro_torch.kernels.moe_combine import moe_combine as MCK  # noqa: E402
from repro_torch.kernels.moe_combine import ops as MC_OPS  # noqa: E402
from repro_torch.kernels.moe_combine import ref as mc_ref  # noqa: E402
from repro_torch.kernels.partition_pack import partition_pack as K  # noqa
from repro_torch.kernels.partition_pack import ref as pp_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as SSD_OPS  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as SK  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.bench_pack import (  # noqa: E402
    host_syncs, is_kernel, is_pp, pack_bytes, profile_record, time_cold_ms,
    time_ms)
from repro_torch.launch import profile_query as PQ  # noqa: E402
from repro_torch.launch.profile_serve import KERNELS  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    grads_of, init_train_state, make_prefill_step, make_train_step,
    prefill_launches, train_launches)
from repro_torch.models import griffin as GR  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.model import build_model, cast_params_  # noqa
from repro_torch.models.modules import (  # noqa: E402
    Sharder, init_params, tree_leaves, tree_map)
from repro_torch.objectstore.store import ObjectStore, StoreConfig  # noqa
from repro_torch import planner as PL  # noqa: E402
from repro_torch import workload as WL  # noqa: E402
from repro_torch.obs.trace import from_chrome  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime.optimizer import make_optimizer  # noqa: E402
from repro_torch.runtime.train_loop import (  # noqa: E402
    ElasticTrainer, JobConfig)
from repro_torch.relational import ops as OPS  # noqa: E402
from repro_torch.relational.table import DictColumn, decode_object  # noqa

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12             # H100 SXM f32, no tensor cores (same)
BF16_FLOP_PER_S = 989e12           # H100 SXM bf16 tensor cores, dense (same)
TF32_FLOP_PER_S = 495e12           # H100 SXM TF32 tensor cores, dense (same)
SF, SEED, TARGET_BYTES = 1.0, 7, 64 << 20
PALLAS_TEST_SHAPES = [(32, 8, 4, 16), (256, 16, 24, 64), (300, 7, 64, 128),
                      (1024, 64, 24, 256)]
MAIN_PARTS = (8, 64, 1024)
EDGE_PARTS = (1, 8, 64, 1024, 8192)
PP_TILE = K.TILE_ROWS
Q12_SCAN_LI = ["l_orderkey", "l_shipmode", "l_shipdate", "l_commitdate",
               "l_receiptdate"]
MULTI = {"shuffle": {"strategy": "multi", "p": 1 / 4, "f": 1 / 4}}
QUERIES = [("q1", {}), ("q3", {}), ("q5", {}), ("q6", {}), ("q12", {}),
           ("q12", MULTI), ("q14", {})]
MUST_PACK = {"q3", "q5", "q12", "q14"}
SSD_CASES = [                      # B, S, H, P, G, N, chunk
    (1, 128, 2, 32, 1, 32, 64), (2, 256, 4, 64, 2, 64, 128),
    (1, 256, 2, 64, 1, 128, 128), (2, 64, 2, 16, 1, 16, 32),  # Pallas test
    (2, 16, 8, 16, 1, 16, 8),                                 # smoke chunk
    (1, 24, 2, 16, 1, 16, 128)]                               # S < chunk
SSD_MAIN = (4, 512, 80, 64, 1, 128, 128)   # the serve phase's prefill
# granite-4.0-h-small's prefill cell in bf16 (bench/, prefill_longdoc):
# 128 heads of 64, one group of state 128, chunk 128, at its longest
# (2 x 16,384: 128 chunks) and shortest (8 x 4096) batch. dt is drawn
# small (softplus(N - 4), about 0.02 a step), so that a chunk decays by
# about e^-2.6 and the state carries across chunks: the inter-chunk pass
# moves y by O(1) and a scan that dropped it fails
SSD_CELL = [(2, 16384, 128, 64, 1, 128, 128),
            (8, 4096, 128, 64, 1, 128, 128)]
SSD_CELL_DT_SHIFT = -4.0
# bf16 keeps 8 significant bits. Prefill (chunked SSD, one GEMM over 2048
# rows) and decode (recurrence, one row at a time) round at other places in
# each of 64 layers, and through random layers the rounding grows with
# depth, for the bf16 prefill against the f32 one as much as for decode
# against prefill (PERF.md). So the bf16 replay is held against the f32
# prefill of the same weights and prompts: at most twice as far from it as
# the bf16 prefill is. A decode that computed something else would land at
# about 1.41 in relative L2 (two unrelated logit vectors of one norm).
SERVE_BF16_FACTOR = 2.0
# the same property in f32 at full depth, at the reference test's 2e-3
# (tests/test_serve_consistency.py), on one prompt of 256 tokens
SERVE_F32_PROMPT, SERVE_F32_TOL = 256, 2e-3
PARITY_LAYERS, PARITY_PROMPT, PARITY_TOL = 4, 256, 1e-3
# card vs CPU in bf16: each side rounds after its own ops (cuBLAS and the
# CPU's GEMMs block their sums differently), as the port and the reference
# do on the CPU, where 4 smoke layers put them 2-4 % apart in relative L2
# (tests/test_torch_mamba.py); held at the same 5 %
PARITY_BF16_TOL = 0.05


# flash_gqa: the Pallas kernel test's CASES (tests/test_kernel_flash_gqa.py),
# smollm-135m's padded-head map (9/3 heads padded to 16/4; padded q heads
# read kv head 0) and the dense serve path's prefill shape (glm4-9b)
SMOLLM_MAP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0)
FLASH_CASES = [                    # B, S, H, Hkv, D, causal, window, map
    (1, 128, 2, 2, 64, True, 0, None), (2, 256, 4, 2, 64, True, 0, None),
    (1, 256, 3, 1, 128, True, 0, None), (2, 128, 2, 2, 32, True, 0, None),
    (1, 384, 2, 1, 64, True, 128, None), (1, 200, 2, 2, 64, True, 0, None),
    (2, 130, 16, 4, 64, True, 0, SMOLLM_MAP)]
FLASH_MAIN = (4, 512, 32, 2, 128, True, 0, None)
# MLA's prefill (deepseek-v2-lite: 16 heads over 16, q/k 192 = 128 nope +
# 64 rope, v 128), and a ragged sequence with a window at that pair
FLASH_MLA = (4, 512, 16, 16, 192, True, 0, None)
FLASH_MLA_EDGE = (2, 65, 4, 4, 192, True, 24, None)
MLA_DV = 128
# this slice's shapes (B, Skv, H, Hkv, D, causal, window, map; Sq where it
# differs from Skv): recurrentgemma-9b's prefill (16 q heads over 1 kv
# head of 256, causal; its window of 2048 does not bind at 512 tokens),
# the same heads at 4096 tokens where the window binds, and whisper-tiny's
# cross attention (6 heads of 64, no mask: 64 prompt tokens at the
# prefill, one at a decode step, against 1500 frames) and encoder; and the
# train path's smollm-135m shape (its train phase's batch, padded heads)
FLASH_NEW = {
    "head_dim_256": ((4, 512, 16, 1, 256, True, 0, None), None),
    "head_dim_256_window": ((1, 4096, 16, 1, 256, True, 2048, None), None),
    "cross_prefill": ((4, 1500, 6, 6, 64, False, 0, None), 64),
    "cross_decode": ((4, 1500, 6, 6, 64, False, 0, None), 1),
    "encoder": ((4, 1500, 6, 6, 64, False, 0, None), None),
    "smollm_train": ((4, 512, 16, 4, 64, True, 0, SMOLLM_MAP), None),
}
# granite-4.0-h-small's NoPE attention (32 query heads over 8 kv heads of
# 128) at its softmax scale, attention_multiplier 1/128 (the launch's
# argument, not 1/sqrt(128)), on the cell's 4096-token requests; the batch
# is cut to 2 of 8, since the plain version holds f32 scores [B, H, S, S]
# (4.3 GB at 2)
FLASH_GRANITE, GRANITE_SCALE = (2, 4096, 32, 8, 128, True, 0, None), 1 / 128
# f32: sums in another order; bf16: each side rounds its f32 output once
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DENSE_ARCH, SMOLLM_ARCH = "glm4-9b", "smollm-135m"
DENSE_F32_PROMPT = 128             # the f32 replay at full depth
DENSE_PARITY_LAYERS, DENSE_PARITY_PROMPT = 2, 128
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_F32_PROMPT = 128               # the f32 replay at full depth
# card vs CPU at full width and a cut depth: the dense layer 0 and two
# MoE layers
MOE_PARITY_LAYERS, MOE_PARITY_PROMPT = 3, 128
# the MoE dispatch at the serve cell's prefill and decode step: 4 groups
# of S tokens, top 6 of 64 experts, d_model 2048 in bf16
MOE_DISPATCH = {"prefill": 512, "decode": 1}
# the expert share of granite-4.0-h-small's prefill cell (bench/,
# prefill_longdoc): top 10 of 72 experts routed, the first 36 held, at the
# cell's batches (B, S): its shortest and longest requests
SHARE_ARCH, SHARE_HELD = "granite-4.0-h-small", 36
SHARE_BATCHES = ((8, 4096), (2, 16384))
# the MoE combine at the two MoE cells' batches of 4096-token requests
# (bench/: deepseek-v2-lite-16b.prefill_long, all 64 experts held;
# granite-4.0-h-small.prefill_longdoc, the first 36 of 72 held), in bf16
COMBINE_CELLS = (("deepseek-v2-lite-16b", 4, 4096, None),
                 ("granite-4.0-h-small", 8, 4096, SHARE_HELD))
# this slice's serve cells (launch/serve.CELLS). recurrentgemma-9b and
# whisper-tiny draw f32 weights and take the f32 answer, as the earlier
# cells do; llama4 draws bf16 (4 of 48 layers, 70.7 GB) and has no f32
# tree on the card. Its bf16 replay is held against its bf16 prefill with
# no drops: through 4 random bf16 layers the two round at other places,
# as deepseek's 27 layers left them 0.1028 apart (PERF.md, PR 19); a
# cache fault puts them O(1) apart
GRIFFIN_ARCH, WHISPER_ARCH = "recurrentgemma-9b", "whisper-tiny"
LLAMA4_ARCH = "llama4-maverick-400b-a17b"
GRIFFIN_F32_PROMPT, WHISPER_F32_PROMPT = 128, 64
LLAMA4_REPLAY_TOL = 0.25
# card vs CPU at each new family's smoke width (d_model 64): a prompt
# longer than griffin's window (8) and llama4's chunk (8); the f32 replay
# on the card at griffin's smoke width, 16 tokens over a window of 8
FAMILY_PARITY_PROMPT, GRIFFIN_REPLAY_PROMPT = 64, 16

# the workload phases: a TPC-H mix of 24 queries (weights of
# workload.TPCH_MIX) with Poisson arrivals at a virtual mean of 5 s, on the
# SF 1 engine of the query phase; the exact cuda-vs-cpu checks (mix, fleet,
# planner, trace) run at SMALL_SF, where the CPU side takes seconds
MIX_QUERIES, MIX_INTERARRIVAL_S = 24, 5.0
SMALL_SF = 0.05
FAILOVER_QUERIES = ("q12", "q3")      # the stages that aggregate floats
PLANNER_GRID = [{"join": nt} for nt in (2, 8, 32)]
GRAD_TOL = 1e-3                       # card vs CPU gradients, f32, of max
TRAIN_LOSS_TOL = 1e-5                 # card vs CPU train loss, f32, relative
# the train phases: (arch, layers; None = the published depth), each at
# full width, f32 parameters, bf16 compute, AdamW at ElasticTrainer's lr,
# TRAIN_STEPS steps on one batch of TRAIN_BATCH x TRAIN_SEQ tokens
TRAIN_CELLS = (("mamba2-2.7b", None), (SMOLLM_ARCH, None),
               (MOE_ARCH, MOE_PARITY_LAYERS))
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 512, 4, 1e-3
# a train step's gradients card vs CPU: smollm-135m at full width and depth
# in f32, on a batch the CPU takes in seconds
TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 2, 256
# the elastic phase (runtime/train_loop.ElasticTrainer on the card): the
# configs' f32 parameters, bf16 compute, the trainer's AdamW at lr 1e-3,
# SyntheticCorpus from the seed. (arch, layers; None = the published
# depth): mamba2-2.7b at 4 of 64 layers, since a checkpoint holds 12 bytes
# a parameter (f32 parameters and both moments) and the host's store holds
# a run's four: 130 GB at 64 layers, 13.9 GB at 4
ELASTIC_CELLS = ((SMOLLM_ARCH, None), ("mamba2-2.7b", 4))
ELASTIC_JOB = JobConfig(steps_per_task=2, total_steps=8, batch=4, seq=512,
                        ckpt_shards=4)
# (task, step) where a worker dies, each once (examples/train_elastic.py):
# task 1 loses the step it ran (2), task 2 dies before its first step
ELASTIC_FAILS = ((1, 3), (2, 4))


# the [dryrun] phase: step 1 holds the step analysis
# (launch/step_analysis.py) of a real step on the card against the same
# step on meta tensors: FLOPs equal, HBM bytes within DRYRUN_BYTES_TOL,
# the meta peak within DRYRUN_PEAK_TOL of max_memory_allocated. Steps:
# (arch, kind, layers; None = the published depth), at TRAIN_BATCH x
# TRAIN_SEQ; the train steps are the train phases' cells (f32 parameters
# and AdamW state, bf16 compute), the prefill the dense serve cell's
# (bf16 weights). Then two production cells of launch/dryrun.py on the
# host, on meshes over a fake process group, with nothing on the card
DRYRUN_STEPS = ((SMOLLM_ARCH, "train", None), ("mamba2-2.7b", "train", None),
                (MOE_ARCH, "train", MOE_PARITY_LAYERS),
                (DENSE_ARCH, "prefill", None))
DRYRUN_BYTES_TOL, DRYRUN_PEAK_TOL = 0.01, 0.10
# the train steps' ms in this phase on an NVIDIA H100 80GB HBM3 at 700 W
# when a flash_gqa call's backward ran attention_ref over every (query,
# key) pair, before it ran the model's algorithm chunk by chunk
# (models/attention.py:attention_vjp); printed beside this run's
TRAIN_MS_BEFORE = {SMOLLM_ARCH: 321.67, "mamba2-2.7b": 899.29,
                   MOE_ARCH: 196.16}
DRYRUN_CELLS = (("glm4-9b", "train_4k", "single"),
                ("mamba2-2.7b", "long_500k", "multi"))
# glm4-9b x train_4k x single as the sandbox's torch 2.13.0+cpu analyzes
# it once the port states its layouts (`python -m repro_torch.launch.dryrun
# --arch glm4-9b --shape train_4k --mesh single`): FLOPs and collective
# bytes a device, which this machine's torch must read within the mesh
# tests' tolerances (tests/_torch_mesh.py: FLOPS_TOL, COLL_TOL)
GLM4_TRAIN_4K = {"torch": "2.13.0+cpu", "flops": 302520316461056.0,
                 "collective_bytes": 267090035527.5}
# step 3 of [dryrun]: every smoke mesh cell of the mesh tests
# (tests/_torch_mesh.py: CELLS x every arch) on this machine's torch, one
# worker process an arch, held against the reference's compiled counts
# (tests/data/torch_mesh_reference.json) with the tests' tolerances
MESH_WORKER_TIMEOUT_S = 600


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def phase(name: str, t0: float):
    """The phase's seconds and peak device memory (then reset)."""
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s, peak "
          f"{torch.cuda.max_memory_allocated()} bytes", flush=True)
    torch.cuda.reset_peak_memory_stats()


def zero_counts():
    K.launches = SK.launches = FK.launches = FK.routed = MCK.launches = 0


def counts() -> dict:
    return {"partition_pack": K.launches, "ssd_scan": SK.launches,
            "flash_gqa": FK.launches, "moe_combine": MCK.launches}


def no_drops(cfg):
    """``cfg`` with a MoE capacity no expert can exceed (the capacity
    factor E / k makes C >= S, and a token picks an expert once); other
    configs as they are."""
    if cfg.moe is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def expected_launches(cfg, decode_steps: int) -> dict:
    """The launches of a prefill and ``decode_steps`` decode steps: decode
    attends over its caches in plain PyTorch, so there the MoE dispatch
    and combine launch once a MoE layer, and whisper's step launches
    flash_gqa once an encoder layer (it encodes the frames again) and once
    a cross attention layer (one query against the frames)."""
    want = prefill_launches(cfg)
    want["partition_pack"] *= 1 + decode_steps
    want["moe_combine"] *= 1 + decode_steps
    if cfg.family == "audio":
        want["flash_gqa"] += decode_steps * (cfg.encoder_layers
                                             + cfg.num_layers)
    return want


@contextlib.contextmanager
def recorded_routes():
    """The experts [T, k] each MoE layer's router picks while the block is
    open, in call order (moe_apply looks ``route`` up at each call)."""
    picks, route = [], MOE.route

    def recording(cfg, p, h):
        w, e, aux = route(cfg, p, h)
        picks.append(e.cpu())
        return w, e, aux
    MOE.route = recording
    try:
        yield picks
    finally:
        MOE.route = route


def routing_differences(a: list, b: list) -> tuple[int, int]:
    """(tokens whose set of k experts differs, tokens routed), over the
    MoE layers of two runs."""
    differ = total = 0
    for x, y in zip(a, b, strict=True):
        x, y = x.sort(-1).values, y.sort(-1).values
        differ += int((x != y).any(-1).sum())
        total += x.shape[0]
    return differ, total


def release():
    """Free what the phase before left to the collector and the caching
    allocator; -> the bytes still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


# ------------------------------------------------------------------ kernel
def check_pack(label: str, groups: list[torch.Tensor], ids: torch.Tensor,
               n_parts: int, capacity: int) -> float:
    """Kernel vs plain on the card, exactly (atol 0 on buf, counts and
    slots): rows whose id lies in [0, n_parts) are ranked among themselves,
    the others get slot -1 and land nowhere. -> the largest |difference|."""
    bufs, counts, slots = K.pack(groups, ids, n_parts, capacity)
    torch.cuda.synchronize()
    wants, want_counts, want_slots = K.plain_pack(groups, ids, n_parts,
                                                  capacity)
    check(torch.equal(counts, want_counts), f"{label}: counts differ")
    check(torch.equal(slots, want_slots), f"{label}: slots differ")
    err = 0.0
    for buf, want in zip(bufs, wants):
        check(buf.shape == want.shape and torch.equal(buf, want),
              f"{label}: buf differs")
        err = max(err, float((buf.double() - want.double()).abs().max())
                  if buf.numel() else 0.0)
    return err


def pack_case(label: str, groups: list[torch.Tensor], ids: torch.Tensor,
              n_parts: int, capacity: int, main: bool = False) -> dict:
    """Kernel vs plain on the card, exactly; warm times and the memory
    bound, and at a main shape the cold time and the device operations of
    one call."""
    before = K.launches
    err = check_pack(label, groups, ids, n_parts, capacity)
    # ids outside [0, n_parts) (an expert share's entries not held) take
    # the plain version that selects the others first
    valid_ids = bool(((ids >= 0) & (ids < n_parts)).all())

    def plain():
        if valid_ids:
            slot, _, keep = pp_ref.pack_indices(ids, n_parts, capacity)
            for g in groups:
                pp_ref.pack_rows(g, ids, slot, keep, n_parts, capacity)
        else:
            K.plain_pack(groups, ids, n_parts, capacity)

    def library():
        order = torch.sort(ids, stable=True).indices
        for g in groups:
            g.index_select(0, order)

    def kernel():
        K.pack(groups, ids, n_parts, capacity)

    T = ids.shape[0]
    moved = pack_bytes(groups, T, n_parts, capacity)
    rec = {"case": label, "T": T, "n_parts": n_parts, "capacity": capacity,
           "groups": [f"{g.dtype}x{g.shape[1]}" for g in groups],
           "kernel_ms": time_ms(kernel),
           "plain_ms": time_ms(plain), "library_ms": time_ms(library),
           "bytes": moved, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
           "max_abs_err": err}
    if main:
        rec.update(kernel_cold_ms=time_cold_ms(kernel),
                   **profile_record(kernel))
        rec["cold_share_of_bound"] = (rec["bound_ms"]
                                      / rec["device_cold_ms"])
        ops = rec["device_ops"]
        want = 2 if n_parts <= K.LOOKBACK_MAX_PARTS else 3
        check(len(ops) == want and all(map(is_pp, ops)),
              f"{label}: {len(ops)} device operations a call, want {want} "
              f"partition_pack kernels: {ops}")
    rec["launches"] = K.launches - before
    print("[kernel] " + json.dumps(rec), flush=True)
    return rec


def mixed_groups(T: int, seed: int, dev) -> list[torch.Tensor]:
    """bf16, int32 and int64 groups in one call, and an int32 group 4 bytes
    off its allocation's start (so it is copied in narrower vectors)."""
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.integers(0, 2 ** 31, T * 4 + 1)
                            .astype(np.int32)).to(dev)
    return [torch.from_numpy(rng.standard_normal((T, 3)).astype(np.float32))
            .to(torch.bfloat16).to(dev),
            torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, (T, 5))
                             .astype(np.int32)).to(dev),
            torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, (T, 2),
                                          dtype=np.int64)).to(dev),
            flat[1:].view(T, 4)]


def edge_cases(dev) -> float:
    """The card tests' edges of the redesign, exactly: every partition
    count (both routes), a hot key, T around a tile, capacity 0 and below
    the largest count, ids out of range. -> the largest |difference|."""
    err = 0.0

    def run(label, T, P, seed, ids=None, cap=None):
        nonlocal err
        rng = np.random.default_rng(seed)
        if ids is None:
            ids = rng.integers(0, P, T).astype(np.int32)
        ids = torch.from_numpy(ids).to(dev)
        top = int(torch.bincount(ids[(ids >= 0) & (ids < P)],
                                 minlength=P).max())
        cap = top if cap is None else cap(top)
        err = max(err, check_pack(f"edge {label} T={T} P={P} C={cap}",
                                  mixed_groups(T, seed, dev), ids, P, cap))

    for P in EDGE_PARTS:
        run("parts", 40_000, P, P)
    for P in (8, 64, 2048):
        run("hot key", 5 * PP_TILE + 17, P, 3,
            ids=np.full(5 * PP_TILE + 17, P - 1, np.int32))
        for T in (1, PP_TILE - 1, PP_TILE + 1, 3 * PP_TILE + 5):
            run("tile edge", T, P, T, cap=lambda top: top + 3)
    for P in (8, 64, 2048):
        run("capacity 0", 3 * PP_TILE + 100, P, P + 1, cap=lambda top: 0)
        run("capacity below", 3 * PP_TILE + 100, P, P + 1,
            cap=lambda top: max(top // 2, 1))
    for P in (8, 64, 1024):
        rng = np.random.default_rng(P + 2)
        T = 2 * PP_TILE + 33
        ids = rng.integers(0, P, T).astype(np.int32)
        bad = rng.random(T) < 0.1
        ids[bad] = rng.choice([-1, -7, P, P + 5, 2 ** 31 - 1], bad.sum())
        run("ids out of range", T, P, P + 2, ids=ids)
    print(f"[kernel] edge cases exact, max |difference| {err}", flush=True)
    return err


def by_key_case(li, groups, dev) -> dict:
    """pack_by_key at the main shape (P = 8): ids equal the plain
    partition_ids, counts their histogram, bufs the plain pack at capacity
    = the largest count; warm and cold times and device operations a call.
    Then op_partition on the split: its host syncs and device operations."""
    key = li["l_orderkey"]
    n = MAIN_PARTS[0]
    bufs, counts, ids = K.pack_by_key(groups, key, n)
    torch.cuda.synchronize()
    want_ids = OPS.partition_ids(key, n)
    check(torch.equal(ids, want_ids), "pack_by_key: ids differ")
    check(counts == torch.bincount(want_ids, minlength=n).tolist(),
          "pack_by_key: counts differ")
    for g, buf in zip(groups, bufs):
        want, _, _, _ = pp_ref.pack(g, want_ids, n, max(counts))
        check(torch.equal(buf, want), "pack_by_key: buf differs")

    def kernel():
        K.pack_by_key(groups, key, n)

    rec = {"case": f"pack_by_key q12 scan_li T={len(key)} P={n}",
           "kernel_ms": time_ms(kernel), "kernel_cold_ms": time_cold_ms(
               kernel), "host_syncs": host_syncs(kernel),
           **profile_record(kernel)}
    print("[kernel] " + json.dumps(rec), flush=True)
    kernels = [o for o in rec["device_ops"] if is_kernel(o)]
    check(rec["host_syncs"] == 1 and len(kernels) == 2
          and all(map(is_pp, kernels)),
          f"pack_by_key: {rec['host_syncs']} syncs, device operations "
          f"{rec['device_ops']}")

    def partition():
        OPS.op_partition(li, "l_orderkey", n)

    ops = profile_record(partition, iters=1)["device_ops"]
    prec = {"op_partition": f"q12 scan_li T={len(key)} P={n}",
            "host_syncs": host_syncs(partition),
            "cuda_kernels": sum(map(is_kernel, ops)), "device_ops": ops,
            "pp_kernels": sum(map(is_pp, ops))}
    print("[op_partition] " + json.dumps(prec), flush=True)
    check(prec["host_syncs"] == 1, f"op_partition synced "
          f"{prec['host_syncs']} times, want 1")
    check(not any("elementwise" in o or "bincount" in o for o in ops),
          f"op_partition ran hash or count kernels outside the pack: {ops}")
    return rec


def kernel_phase(tables, split_rows: int, dev) -> list[dict]:
    """-> every case's record, the main path's own shape (8 partitions)
    first."""
    recs = []
    for T, P, C, d in PALLAS_TEST_SHAPES:
        rng = np.random.default_rng(T + P)
        rows = torch.from_numpy(rng.standard_normal((T, d))
                                .astype(np.float32)).to(dev)
        ids = torch.from_numpy(rng.integers(0, P, T).astype(np.int32)) \
            .to(dev)
        for dt in (torch.float32, torch.bfloat16):
            recs.append(pack_case(f"pallas-test {T}x{d} P={P} C={C} {dt}",
                                  [rows.to(dt)], ids, P, C))
    edge_err = edge_cases(dev)
    li = tables["lineitem"].project(Q12_SCAN_LI) \
        .take(torch.arange(split_rows)).to(dev)
    (n8, n4), views = OPS.width_groups(li)
    groups = [torch.stack([views[c] for c in g], 1) for g in (n8, n4)]
    main = []
    for n in MAIN_PARTS:
        ids = OPS.partition_ids(li["l_orderkey"], n)
        cap = int(torch.bincount(ids, minlength=n).max())
        main.append(pack_case(f"main q12 scan_li T={split_rows} P={n}",
                              groups, ids, n, cap, main=True))
    main[0]["by_key"] = by_key_case(li, groups, dev)
    main[0]["max_abs_err"] = max(main[0]["max_abs_err"], edge_err)
    return main + recs


# ------------------------------------------------------------------- query
def _canon(t) -> dict:
    cols = {}
    for n in sorted(t.column_names()):
        c = t[n]
        c = c.codes if isinstance(c, DictColumn) else c
        cols[n] = c.cpu().numpy().astype(np.float64)
    if not cols:
        return cols
    order = np.lexsort(tuple(cols.values()))
    return {n: v[order] for n, v in cols.items()}


def same_result(got, want, what: str):
    g, w = _canon(got), _canon(want)
    check(sorted(g) == sorted(w), f"{what}: columns {sorted(g)} vs "
          f"{sorted(w)}")
    for n in w:
        check(g[n].shape == w[n].shape, f"{what}:{n}: shape {g[n].shape} "
              f"vs {w[n].shape}")
        check(bool(np.isfinite(g[n]).all()), f"{what}:{n}: not finite")
        check(np.allclose(g[n], w[n], rtol=1e-9, atol=1e-6),
              f"{what}:{n}: differs from the oracle")


def query_phase(coord, tables) -> int:
    expected = {}
    for q, kw in QUERIES:
        before = K.launches
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run_query(coord, q, None, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = K.launches - before
        if q not in expected:
            expected[q] = oracle(q, tables)      # CPU, plain versions
        same_result(res.result, expected[q], q)
        print("[query] " + json.dumps({
            "query": q + ("-multi" if kw else ""),
            "latency_s": res.latency_s, "wall_s": wall,
            "cost": res.cost.total, "tasks": res.task_count,
            "gets": res.cost.gets, "puts": res.cost.puts,
            "partition_pack_launches": delta,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "attribution": res.attribution}),
            flush=True)
        if q in MUST_PACK:
            check(delta > 0, f"{q}: partition_pack never launched")
    return K.launches, expected


def parity_phase():
    runs = {}
    for dev in ("cuda", "cpu"):
        coord, _ = make_engine(sf=SF, seed=SEED, device=dev,
                               target_bytes=TARGET_BYTES, compute_scale=0.0,
                               executor_workers=1)
        runs[dev] = [run_query(coord, q) for q in ("q3", "q12")]
    for q, a, b in zip(("q3", "q12"), runs["cuda"], runs["cpu"]):
        got = (a.latency_s, a.cost.total, a.cost.gets, a.cost.puts,
               a.task_count)
        want = (b.latency_s, b.cost.total, b.cost.gets, b.cost.puts,
                b.task_count)
        print(f"[parity] {q} cuda {got} cpu {want}", flush=True)
        check(got == want, f"{q}: cuda and cpu runs differ structurally")


# ---------------------------------------------------------- workload phases
def finite(*xs) -> bool:
    return all(np.isfinite(x) for x in xs)


def mix_args():
    return (WL.sample_mix(WL.TPCH_MIX, MIX_QUERIES, seed=SEED),
            WL.poisson(MIX_QUERIES, MIX_INTERARRIVAL_S, seed=SEED))


def workload_phase(coord) -> int:
    """The query phase's SF 1 engine behind Session.from_coordinator runs
    a 24-query TPC-H mix through run_mix: every shuffle producer on
    partition_pack, no serve kernel. -> partition_pack's launches."""
    zero_counts()                                # the workload path's count
    t0 = time.perf_counter()
    wl = Session.from_coordinator(coord).run_mix(*mix_args())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    fr = WL.frontier(wl.cost_per_query)
    summ = wl.summary
    print("[workload] " + json.dumps({
        "queries": summ["queries"], "sf": SF,
        "mean_interarrival_s": MIX_INTERARRIVAL_S,
        "latency_s_p50": summ["latency_s_p50"],
        "latency_s_p99": summ["latency_s_p99"],
        "queue_delay_s_p99": summ["queue_delay_s_p99"],
        "makespan_s": wl.makespan_s, "cost_per_query": wl.cost_per_query,
        "wall_s": wall, "partition_pack_launches": launched["partition_pack"],
        "break_even_threshold_s": fr.threshold_s,
        "break_even_s": fr.break_even_s}), flush=True)
    check(launched["partition_pack"] > 0,
          "partition_pack never launched on the workload path")
    check(launched["ssd_scan"] == launched["flash_gqa"] == 0,
          f"serve kernels launched on the workload path: {launched}")
    check(len(wl.records) == MIX_QUERIES and all(
        finite(r.arrival_s, r.queue_delay_s, r.latency_s, r.cost.total)
        and not r.failed for r in wl.records), "a workload record is not "
          "finite or failed")
    check(finite(fr.threshold_s), f"break-even threshold {fr.threshold_s}")
    return launched["partition_pack"]


def _record_sig(r) -> tuple:
    return (r.name, r.tenant, r.rejected, r.arrival_s, r.queue_delay_s,
            r.latency_s, r.cost.total, r.cost.gets, r.cost.puts,
            r.task_count, r.backup_count, r.columns_read)


def _fleet_streams():
    """fg: foreground under a slot quota; bg: background, rejected past
    one query in flight."""
    return [WL.TenantStream.open_loop(
                WL.TenantSpec("fg", slot_quota=16), WL.TPCH_MIX, 4,
                mean_interarrival_s=2.0, seed=1),
            WL.TenantStream.open_loop(
                WL.TenantSpec("bg", priority="background",
                              admission="reject", max_inflight=1),
                WL.TPCH_MIX, 4, mean_interarrival_s=0.5, seed=2)]


def small_session(dev: str, **kw) -> Session:
    return Session(sf=SMALL_SF, seed=SEED, compute_scale=0.0,
                   executor_workers=1, device=dev, **kw)


def workload_parity_phase():
    """run_mix and an exact two-tenant run_fleet on cuda and on cpu at
    compute_scale=0: records and fleet numbers equal exactly."""
    out = {}
    for dev in ("cuda", "cpu"):
        wl = small_session(dev).run_mix(*mix_args())
        fr = small_session(dev).run_fleet(_fleet_streams(), mode="exact")
        out[dev] = ([_record_sig(r) for r in wl.records], wl.summary,
                    [_record_sig(r) for r in fr.records], fr.tenants,
                    fr.quota_max_held, fr.rejected, fr.event_pops)
    got, want = out["cuda"], out["cpu"]
    print("[workload-parity] " + json.dumps({
        "sf": SMALL_SF, "mix_queries": len(got[0]),
        "mix_latency_s_p99": got[1]["latency_s_p99"],
        "fleet_queries": len(got[2]),
        "fg_latency_s_p99": got[3]["fg"]["latency_s_p99"],
        "bg_latency_s_p99": got[3]["bg"]["latency_s_p99"],
        "quota_max_held": got[4], "rejected": got[5],
        "event_pops": got[6], "equal": got == want}), flush=True)
    check(got == want, "cuda and cpu workload runs differ")
    check(got[5] > 0 and got[4]["fg"] <= 16,
          f"fleet admission or quota not exercised: {got[4]}, {got[5]}")


def failover_phase(coord, expected: dict):
    """run_with_failover of q12 and q3 on the card at compute_scale=0
    over the SF 1 store, killed halfway: the replay passes the store's
    immutability audit (every re-PUT byte-identical); latency, cost and
    journal frontier equal a run with no kill; the rows equal the
    oracle's."""
    c0 = Coordinator(coord.store, coord.base_splits, coord.policy,
                     seed=coord.seed, max_parallel=coord.max_parallel,
                     compute_scale=0.0, executor_workers=1,
                     device=coord.device)
    sess = Session.from_coordinator(c0)
    for q in FAILOVER_QUERIES:
        journal = Journal()
        whole = sess.spawn(journal).run_query(QuerySpec(q).build_plan())
        kill = journal.count // 2
        t0 = time.perf_counter()
        res, j = sess.run_with_failover(q, kill_after=kill)
        torch.cuda.synchronize()
        print("[failover] " + json.dumps({
            "query": q, "event_pops": journal.count, "kill_after": kill,
            "latency_s": res.latency_s, "cost": res.cost.total,
            "replay_wall_s": time.perf_counter() - t0,
            "checkpoints": len(j.entries)}), flush=True)
        check((res.latency_s, res.cost) == (whole.latency_s, whole.cost),
              f"{q}: failover latency or cost differs from the run with no "
              "kill")
        check(j.frontier == journal.frontier, f"{q}: journal frontier "
              "differs")
        same_result(res.result, expected[q], f"{q} failover")


def trace_phase():
    """q12 and q3 through Session(trace=True, metrics=True) on the card:
    results and latency equal the untraced run's; the Chrome export
    round-trips."""
    import tempfile
    traced = small_session("cuda", trace=True, metrics=True)
    plain = small_session("cuda")
    for q in FAILOVER_QUERIES:
        a, b = traced.submit(q), plain.submit(q)
        check((a.latency_s, a.cost, a.task_count)
              == (b.latency_s, b.cost, b.task_count),
              f"{q}: traced run differs from the untraced one")
        same_result(a.result, b.result, f"{q} traced")
    traced.tracer.finalize()
    traced.tracer.validate()
    spans = list(traced.tracer.spans())
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        events = traced.tracer.to_chrome(str(path))
        rebuilt = [sp for r in from_chrome(json.loads(path.read_text()))
                   for sp in r.walk()]
    metrics = traced.metrics.registry.collect()
    print("[trace] " + json.dumps({
        "queries": list(FAILOVER_QUERIES), "spans": len(spans),
        "chrome_events": len(events), "metrics": len(metrics),
        "gets": metrics["gets"]["value"],
        "queries_seen": metrics["queries"]["value"]}), flush=True)
    check(len(rebuilt) == len(spans) > 0, "Chrome export lost spans")
    check(metrics["queries"]["value"] == len(FAILOVER_QUERIES),
          "metrics saw another number of queries")


def planner_phase():
    """pareto_search for q12 over a small grid on the card and on the CPU:
    equal frontiers (configs, predicted and simulated latency and
    cost)."""
    out = {}
    for dev in ("cuda", "cpu"):
        coord, _ = make_engine(sf=SMALL_SF, seed=SEED, compute_scale=0.0,
                               executor_workers=1, record_events=True,
                               device=dev)
        model, _ = PL.QueryModel.from_probe(coord, "q12", {"join": 8})
        ev = PL.QueryEvaluator(coord.store, coord.base_splits, "q12",
                               seed=SEED, max_parallel=coord.max_parallel,
                               executor_workers=1, device=dev)
        grid = [PL.PlanConfig.make(nt, parallel_reads=pr)
                for nt in PLANNER_GRID for pr in (8, 16)]
        sr = PL.pareto_search(model, ev, grid,
                              must_confirm=tuple(grid[::2]))
        out[dev] = [(p.config, p.pred_latency_s, p.pred_cost_usd,
                     p.sim_latency_s, p.sim_cost_usd) for p in sr.frontier]
        n_conf = sr.sim_evals
    print("[planner] " + json.dumps({
        "sf": SMALL_SF, "grid": len(PLANNER_GRID) * 2, "confirmed": n_conf,
        "frontier": [(dict(c.ntasks), c.parallel_reads, sl, sc)
                     for c, _, _, sl, sc in out["cuda"]],
        "equal": out["cuda"] == out["cpu"]}), flush=True)
    check(out["cuda"] == out["cpu"] and out["cuda"],
          "cuda and cpu planner frontiers differ")


def grad_phase(dev):
    """The gradients of a dense smoke layer's wq/wk/wv through flash_gqa
    on the card against the CPU's (plain versions), f32, within GRAD_TOL of
    each gradient's largest entry; the card's backward (the model's
    attention chunk by chunk, ``flash_gqa.grads``) run again gives the
    same bits (C5)."""
    cfg = smoke_config("glm4-9b").replace(compute_dtype=torch.float32)
    x_np = np.random.default_rng(SEED).standard_normal(
        (2, 128, cfg.d_model)).astype(np.float32)
    cpu_params = init_params(TT.attn_defs(cfg),
                             torch.Generator().manual_seed(SEED), "cpu")
    grads, launched = {}, []
    for d in (dev, torch.device("cpu")):
        p = tree_map(lambda t: t.to(d).requires_grad_(), cpu_params,
                     is_leaf=torch.is_tensor)
        x = torch.from_numpy(x_np).to(d)
        pos = torch.arange(x.shape[1], device=d)[None]
        launched.append(FK.launches)
        out, _ = TT.attn_apply(cfg, p, x, Sharder(), positions=pos)
        launched.append(FK.launches)
        gs = torch.autograd.grad(out.square().sum(),
                                 [p["wq"], p["wk"], p["wv"]])
        launched.append(FK.launches)
        grads[d.type] = [g.cpu() for g in gs]
    p = tree_map(lambda t: t.to(dev).requires_grad_(), cpu_params,
                 is_leaf=torch.is_tensor)
    x = torch.from_numpy(x_np).to(dev)
    pos = torch.arange(x.shape[1], device=dev)[None]
    out, _ = TT.attn_apply(cfg, p, x, Sharder(), positions=pos)
    again = torch.autograd.grad(out.square().sum(),
                                [p["wq"], p["wk"], p["wv"]])
    same_bits = all(torch.equal(a.cpu(), b)
                    for a, b in zip(again, grads["cuda"]))
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(grads["cuda"], grads["cpu"])]
    print("[grad] " + json.dumps({
        "layer": "glm4-9b smoke attention", "head_dim": cfg.head_dim,
        "rel_max_err_wq_wk_wv": errs, "same_bits_again": same_bits,
        "flash_gqa_launches_forward_backward": [
            launched[1] - launched[0], launched[2] - launched[1]]}),
        flush=True)
    check(launched[1] - launched[0] == 1
          and launched[2] == launched[1] == launched[5],
          f"want one flash_gqa launch in the card's forward and none "
          f"elsewhere: {launched}")
    check(all(bool(torch.isfinite(g).all()) for g in grads["cuda"]),
          "card gradients not finite")
    check(max(errs) <= GRAD_TOL, f"card gradients differ from the CPU's: "
          f"{errs}")
    check(same_bits, "the card's attention backward gave other bits on a "
          "second run")


# -------------------------------------------------------------- ssd kernel
def ssd_inputs(B, S, H, P, G, N, seed, dev, dtype=torch.float32,
               dt_shift=-1.0):
    """x, dt (post-softplus, softplus(N(0, 1) + ``dt_shift``)), A, Bm, Cm
    from numpy, as the Pallas kernel test draws them."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f)
    dt = np.logaddexp(rng.standard_normal((B, S, H)) + dt_shift, 0).astype(f)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(f)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(f)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(f)
    t = lambda a: torch.from_numpy(a).to(dev)
    return (t(x).to(dtype), t(dt), t(A), t(Bm).to(dtype), t(Cm).to(dtype))


def ssd_case(label, shape, dev, dtype=torch.float32, timed=False,
             dt_shift=-1.0) -> dict:
    """Kernel vs plain on the card: y and state within rtol = atol = 2e-4
    in f32; in bf16 the state so too and y within one bf16 step (2^-7
    relative: each side rounds its own f32 sum once). ``dt_shift``: see
    ``ssd_inputs``."""
    B, S, H, P, G, N, chunk = shape
    args = ssd_inputs(B, S, H, P, G, N, S + P, dev, dtype, dt_shift)
    y, st = SK.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    y_r, st_r = ssd_chunked(*args, chunk)
    y_tol = (2e-4, 2e-4) if dtype == torch.float32 else (2 ** -7, 2e-4)
    for what, got, want, (rtol, atol) in (("y", y, y_r, y_tol),
                                          ("state", st, st_r, (2e-4, 2e-4))):
        got, want = got.float(), want.float()
        check(bool(torch.isfinite(got).all()), f"{label}: {what} not finite")
        check(bool(((got - want).abs() <= atol + rtol * want.abs()).all()),
              f"{label}: {what} differs from the plain version by "
              f"{float((got - want).abs().max())}")
    rec = {"case": label, "shape": shape, "dtype": str(dtype),
           "max_abs_err_y": float((y.float() - y_r.float()).abs().max()),
           "max_abs_err_state": float((st - st_r).abs().max())}
    if timed:
        flops, nbytes = SSD_OPS.work((B, S, H, P), (B, S, G, N),
                                     chunk=chunk,
                                     elem_bytes=y.element_size())
        rec.update(
            kernel_ms=time_ms(lambda: SK.ssd_scan(*args, chunk=chunk)),
            plain_ms=time_ms(lambda: ssd_chunked(*args, chunk)),
            flops=flops, bytes=nbytes,
            bound_ms=max(flops / F32_FLOP_PER_S,
                         nbytes / HBM_BYTES_PER_S) * 1e3,
            # the same operations at the pipe the kernels use: 3xTF32,
            # three TF32 products for one f32 product
            bound_3xtf32_ms=max(3 * flops / TF32_FLOP_PER_S,
                                nbytes / HBM_BYTES_PER_S) * 1e3,
            bound_by="operations" if flops / F32_FLOP_PER_S
            >= nbytes / HBM_BYTES_PER_S else "bytes")
    print("[ssd] " + json.dumps(rec), flush=True)
    return rec


def ssd_phase(dev) -> tuple[dict, float]:
    """-> (the main shape's record in the serve path's bf16, the largest
    f32 error of any case)."""
    err = 0.0
    for shape in SSD_CASES:
        r = ssd_case(f"case {shape}", shape, dev)
        err = max(err, r["max_abs_err_y"], r["max_abs_err_state"])
    r = ssd_case(f"main {SSD_MAIN} f32", SSD_MAIN, dev, timed=True)
    err = max(err, r["max_abs_err_y"], r["max_abs_err_state"])
    main_rec = ssd_case(f"main {SSD_MAIN} bf16", SSD_MAIN, dev,
                        torch.bfloat16, timed=True)
    err = max(err, ssd_cell_cases(dev))
    return main_rec, err


def ssd_cell_cases(dev) -> float:
    """``SSD_CELL`` in bf16 with dt drawn small, first with the state
    carried: y without the inter-chunk pass (each chunk from a zero state,
    one call a chunk of the plain version) must differ from the plain
    version by more than the check's tolerance, else the case could not
    see a scan that dropped it. -> the largest error."""
    err = 0.0
    for shape in SSD_CELL:
        B, S, H, P, G, N, chunk = shape
        x, dt, A, Bm, Cm = ssd_inputs(B, S, H, P, G, N, S + P, dev,
                                      torch.bfloat16, SSD_CELL_DT_SHIFT)
        y_r, _ = ssd_chunked(x, dt, A, Bm, Cm, chunk)
        y_r = y_r.float()
        c = S // chunk
        fold = lambda t: t.reshape(B, c, chunk, *t.shape[2:]).flatten(0, 1)
        y_cut, _ = ssd_chunked(fold(x), fold(dt), A, fold(Bm), fold(Cm),
                               chunk)
        moved = (y_cut.float().reshape(y_r.shape) - y_r).abs()
        carried = bool((moved > 2e-4 + 2 ** -7 * y_r.abs()).any())
        del x, dt, Bm, Cm, y_r, y_cut
        check(carried, f"ssd cell {shape}: the inter-chunk pass moves y by "
              f"at most {float(moved.max())}, inside the tolerance")
        print("[ssd] " + json.dumps({
            "case": f"cell {shape}", "inter_chunk_max_abs": float(
                moved.max()), "inter_chunk_mean_abs": float(moved.mean())}),
              flush=True)
        del moved
        r = ssd_case(f"cell {shape} bf16", shape, dev, torch.bfloat16,
                     dt_shift=SSD_CELL_DT_SHIFT)
        err = max(err, r["max_abs_err_y"], r["max_abs_err_state"])
        torch.cuda.empty_cache()
    return err


# ------------------------------------------------------------------- serve
def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def serve_phase(dev, arch: str, f32_prompt: int) -> dict:
    """The serve cell of ``arch`` (launch/serve.CELLS) at full width and
    depth. The weights are drawn in f32 on the card, and while only that
    tree is there the f32 answer is taken (the prefill of the cell's
    prompts) and the serve-consistency property is held in f32 (one
    prompt of ``f32_prompt`` tokens replayed through decode, at the
    reference test's 2e-3). Then the tree is cast to bf16 in place, leaf
    by leaf (``cast_params_``: the card never holds both trees), and the
    cell is served through launch/serve.generate after a short warm-up
    request: each kernel must launch as often as the path calls it
    (``expected_launches``), no attention call may be routed to the plain
    path, and the bf16 replay must lie within SERVE_BF16_FACTOR of the
    bf16 prefill's distance from the f32 answer. A MoE prefill drops the
    entries past each expert's capacity and a decode step never does, so
    for a MoE cell the f32 answer, the f32 replay and the bf16 prefill
    the replay is held against run with no drops (``no_drops``), as
    tests/test_serve_consistency.py runs the reference. Whisper's frames
    go with every prefill and decode step. -> the kernels' launches in the
    counted run."""
    cell = serve.CELLS[arch]
    cfg = cell.config()
    ccfg = no_drops(cfg)
    B = cell.batch
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, tokens, frames = serve.random_request(cfg, B, cell.prompt,
                                                  cell.seed, dev)
    first = frames[:1] if frames is not None else None
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {sum(t.numel() for t in tree_leaves(params))} "
          f"parameters ({cfg.param_dtype}), compute {cfg.compute_dtype}; "
          f"init {time.perf_counter() - t0:.3f} s; allocated "
          f"{torch.cuda.memory_allocated()} bytes", flush=True)

    # the f32 answer on the same weights and prompts, and the f32 replay
    cfg32 = ccfg.replace(compute_dtype=torch.float32)
    b32 = build_model(cfg32)
    l32, _ = make_prefill_step(b32)(params, serve.prefill_batch(
        b32, tokens.to(dev), frames))
    l32 = l32.float()
    one = serve.generate(cfg32, params, tokens[:1, :f32_prompt], 1, dev,
                         first)
    lp, lr = one.prefill_logits, one.replay_logits
    err = float((lr - lp).abs().max())
    print("[serve-f32] " + json.dumps({
        "arch": cfg.name, "prompt": f32_prompt,
        "replay_vs_prefill_max_abs": err,
        "replay_vs_prefill_rel_l2": rel_l2(lr, lp),
        "decode_ms_per_step": one.decode_s / one.decode_steps * 1e3}),
        flush=True)
    check(bool(((lr - lp).abs() <= SERVE_F32_TOL
                + SERVE_F32_TOL * lp.abs()).all()),
          f"f32 decode replay vs prefill differ by {err}")
    del one, lp, lr
    f32_peak = torch.cuda.max_memory_allocated()

    release()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cast_params_(cfg, params)
    torch.cuda.synchronize()
    cast_s, cast_peak = time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated()
    release()
    serve.generate(cfg, params, tokens[:, :128], 2, dev,
                   frames)                                 # warm-up request

    zero_counts()                                      # the serve path's count
    torch.cuda.reset_peak_memory_stats()
    out = serve.generate(cfg, params, tokens, cell.new, dev, frames)
    launched, routed = counts(), FK.routed
    max_mem = torch.cuda.max_memory_allocated()
    want = expected_launches(cfg, out.decode_steps)
    lp, lr = out.prefill_logits.float(), out.replay_logits.float()
    if ccfg is not cfg:             # the bf16 prefill with no drops
        lp = no_drop_prefill(ccfg, params, tokens.to(dev))
    e_prefill, e_replay = rel_l2(lp, l32), rel_l2(lr, l32)
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "batch": B,
           "prompt": cell.prompt, "new_tokens": cell.new,
           "prefill_s": out.prefill_s,
           "decode_s": out.decode_s, "decode_steps": out.decode_steps,
           "decode_ms_per_step": out.decode_s / out.decode_steps * 1e3,
           "tokens_per_s": B * cell.new / (out.prefill_s + out.decode_s),
           "max_memory_allocated": max_mem,
           "f32_peak_memory_allocated": f32_peak,
           "cast_s": cast_s, "cast_peak_memory_allocated": cast_peak,
           "launches": launched, "expected_launches": want,
           "flash_gqa_routed": routed,
           "replay_vs_prefill_rel_l2": rel_l2(lr, lp),
           "prefill_vs_f32_rel_l2": e_prefill,
           "replay_vs_f32_rel_l2": e_replay,
           "cell_prefill_vs_no_drops_rel_l2": rel_l2(
               out.prefill_logits.float(), lp),
           "logit_scale_max_abs": float(l32.abs().max()),
           "tokens": out.tokens[0, :8].tolist(),
           **part_times(cfg, params, tokens, frames, dev)}
    print("[serve] " + json.dumps(rec), flush=True)
    check(launched == want, f"{arch}: kernels launched {launched} times on "
          f"the serve path, want {want}")
    check(routed == 0, f"{routed} attention calls routed to the plain path "
          f"on the {arch} serve path")
    check(tuple(lp.shape) == (B, 1, cfg.vocab_size),
          f"prefill logits of shape {tuple(lp.shape)}")
    check(bool(torch.isfinite(lp).all() and torch.isfinite(lr).all()
               and torch.isfinite(l32).all()), "serve logits not finite")
    check(tuple(out.tokens.shape) == (B, cell.new)
          and int(out.tokens.min()) >= 0
          and int(out.tokens.max()) < cfg.vocab_size,
          f"generated tokens {tuple(out.tokens.shape)} out of range")
    check(e_replay <= SERVE_BF16_FACTOR * e_prefill,
          f"bf16 decode replay {e_replay} from the f32 answer, more than "
          f"{SERVE_BF16_FACTOR} x the bf16 prefill's {e_prefill}")
    return launched


def part_times(cfg, params, tokens, frames, dev) -> dict:
    """Parts of this slice's serve cells that no kernel of the port covers
    (CUDA events, mean of 20 calls, on the cell's bf16 weights):
    griffin's RG-LRU scan (plain PyTorch, models/griffin._rglru) at one
    recurrent layer's prefill shape, and whisper's encoder, which every
    decode step runs again, beside a whole decode step."""
    B, S = tokens.shape
    with torch.inference_mode():
        if cfg.family == "hybrid":
            gen = torch.Generator(device=dev).manual_seed(0)
            xc, ag, ig = (torch.randn(B, S, cfg.lru_width, generator=gen,
                                      device=dev).to(cfg.compute_dtype)
                          for _ in range(3))
            lam = torch.randn(cfg.lru_width, generator=gen, device=dev)
            return {"rglru_scan_ms": time_ms(
                lambda: GR._rglru(xc, ag, ig, lam)),
                "rglru_shape": [B, S, cfg.lru_width]}
        if cfg.family == "audio":
            bundle = build_model(cfg)
            f = frames.to(dev, cfg.compute_dtype)
            cache = init_params(bundle.cache_defs(B, S + 1), None, dev)
            cache["len"] = torch.tensor(S, dtype=torch.int32, device=dev)
            batch = {"token": tokens[:, -1:].to(dev), "frames": f}
            enc = time_ms(lambda: bundle.encode(params, f))
            step = time_ms(lambda: bundle.decode_fn(params, cache, batch))
            return {"encode_ms": enc, "decode_step_ms": step,
                    "encode_share_of_step": enc / step}
    return {}


def no_drop_prefill(ccfg, params, tokens) -> torch.Tensor:
    """The last logits of a prefill of ``tokens`` [B, S] at ``ccfg``'s
    capacity with no drops (``no_drops``), one batch row at a time: a MoE
    layer dispatches each row as its own group, so with nothing dropped a
    row's logits do not depend on the others, and one row's expert buffer
    (C = S at capacity factor E/k) is a B-th of the batch's. -> f32."""
    bc = build_model(ccfg)
    step = make_prefill_step(bc)
    return torch.cat([step(params, serve.prefill_batch(
        bc, tokens[b:b + 1]))[0].float() for b in range(tokens.shape[0])])


def llama4_serve_phase(dev) -> dict:
    """The serve cell of llama4 (launch/serve.CELLS): its published width,
    4 of its 48 layers (one super-block: chunked + dense, chunked + MoE,
    chunked + dense, global NoPE + MoE), its parameters drawn in bf16 as
    the config declares (35.3 B, 70.7 GB; an f32 tree would take 141 GB,
    so this cell has no f32 answer, and its f32 properties are held at the
    smoke width in the llama4 parity phase). After a short warm-up
    request, 4 prompts of 512 tokens and 32 new tokens go through
    launch/serve.generate: each kernel must launch as often as the path
    calls it, no attention call may be routed to the plain path, every
    logit is finite and every token in range, and the bf16 replay of the
    prompts through decode must lie within LLAMA4_REPLAY_TOL (relative L2)
    of the bf16 prefill with no drops (``no_drop_prefill``; decode never
    drops, the cell's prefill does at capacity 8). -> the kernels'
    launches in the counted run."""
    cell = serve.CELLS[LLAMA4_ARCH]
    cfg = cell.config()
    B = cell.batch
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, tokens, _ = serve.random_request(cfg, B, cell.prompt, cell.seed,
                                             dev)
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated()
    print(f"[serve] {cfg.name}: {cfg.num_layers} of 48 layers, d_model "
          f"{cfg.d_model}, {sum(t.numel() for t in tree_leaves(params))} "
          f"parameters ({cfg.param_dtype}), compute {cfg.compute_dtype}; "
          f"init {init_s:.3f} s, peak {init_peak} bytes; allocated "
          f"{torch.cuda.memory_allocated()} bytes", flush=True)
    cast_params_(cfg, params)                  # the norm scales, to bf16
    serve.generate(cfg, params, tokens[:, :128], 2, dev)   # warm-up request

    zero_counts()                                      # the serve path's count
    torch.cuda.reset_peak_memory_stats()
    out = serve.generate(cfg, params, tokens, cell.new, dev)
    launched, routed = counts(), FK.routed
    max_mem = torch.cuda.max_memory_allocated()
    want = expected_launches(cfg, out.decode_steps)
    torch.cuda.reset_peak_memory_stats()
    lp = no_drop_prefill(no_drops(cfg), params, tokens.to(dev))
    no_drop_peak = torch.cuda.max_memory_allocated()
    lr = out.replay_logits.float()
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "batch": B,
           "prompt": cell.prompt, "new_tokens": cell.new,
           "prefill_s": out.prefill_s, "decode_s": out.decode_s,
           "decode_steps": out.decode_steps,
           "decode_ms_per_step": out.decode_s / out.decode_steps * 1e3,
           "tokens_per_s": B * cell.new / (out.prefill_s + out.decode_s),
           "init_s": init_s, "init_peak_memory_allocated": init_peak,
           "max_memory_allocated": max_mem,
           "no_drop_prefill_peak_memory_allocated": no_drop_peak,
           "card_memory": torch.cuda.get_device_properties(dev).total_memory,
           "launches": launched, "expected_launches": want,
           "flash_gqa_routed": routed,
           "replay_vs_no_drop_prefill_rel_l2": rel_l2(lr, lp),
           "cell_prefill_vs_no_drops_rel_l2": rel_l2(
               out.prefill_logits.float(), lp),
           "logit_scale_max_abs": float(lp.abs().max()),
           "tokens": out.tokens[0, :8].tolist()}
    print("[serve] " + json.dumps(rec), flush=True)
    check(launched == want, f"{cfg.name}: kernels launched {launched} "
          f"times on the serve path, want {want}")
    check(routed == 0, f"{routed} attention calls routed to the plain path "
          f"on the {cfg.name} serve path")
    check(tuple(out.prefill_logits.shape) == (B, 1, cfg.vocab_size),
          f"prefill logits of shape {tuple(out.prefill_logits.shape)}")
    check(bool(torch.isfinite(out.prefill_logits).all()
               and torch.isfinite(lr).all() and torch.isfinite(lp).all()),
          "serve logits not finite")
    check(tuple(out.tokens.shape) == (B, cell.new)
          and int(out.tokens.min()) >= 0
          and int(out.tokens.max()) < cfg.vocab_size,
          f"generated tokens {tuple(out.tokens.shape)} out of range")
    check(rec["replay_vs_no_drop_prefill_rel_l2"] <= LLAMA4_REPLAY_TOL,
          f"bf16 decode replay {rec['replay_vs_no_drop_prefill_rel_l2']} "
          f"from the bf16 prefill with no drops, above {LLAMA4_REPLAY_TOL}")
    return launched


def replay_parity(cfg, prompt: int, dev):
    """The serve-consistency property on the card at ``cfg`` in f32: the
    prompt replayed through decode (for griffin, a prompt longer than its
    window, so the ring of the window layers wraps) gives the prefill's
    last logits within SERVE_F32_TOL."""
    cfg = cfg.replace(compute_dtype=torch.float32)
    params, tokens, frames = serve.random_request(cfg, 2, prompt, 0, dev)
    out = serve.generate(cfg, params, tokens, 1, dev, frames)
    lp, lr = out.prefill_logits.float(), out.replay_logits.float()
    err = float((lr - lp).abs().max())
    print("[replay] " + json.dumps({
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "window": cfg.window, "prompt": prompt, "max_abs_err": err,
        "rel_l2": rel_l2(lr, lp)}), flush=True)
    check(bool(((lr - lp).abs() <= SERVE_F32_TOL
                + SERVE_F32_TOL * lp.abs()).all()),
          f"{cfg.name}: f32 decode replay vs prefill differ by {err} on "
          "the card")


def prefill_parity(cfg, prompt: int, dev, dtypes):
    """Prefill on the card (each kernel as often as a prefill calls it,
    ``prefill_launches``, and no attention call routed) against prefill on
    the CPU (plain versions) on identical weights, drawn on the card and
    copied over: f32 within PARITY_TOL, bf16 within PARITY_BF16_TOL
    relative L2. For a MoE config it also counts the tokens whose experts
    differ between the two sides: a router near a tie can pick another
    expert under other rounding, and that shows as this count."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params, tokens, frames = serve.random_request(cfg, 1, prompt, 0, dev)
    on_cpu = tree_map(lambda t: t.cpu(), params)
    for dtype in dtypes:
        bundle = build_model(cfg.replace(compute_dtype=dtype))
        step = make_prefill_step(bundle)
        before, routed = counts(), FK.routed
        with recorded_routes() as on_card:
            got, _ = step(params, serve.prefill_batch(bundle,
                                                      tokens.to(dev),
                                                      frames))
        got = got.cpu().float()
        launched = {k: n - before[k] for k, n in counts().items()}
        routed = FK.routed - routed
        with recorded_routes() as off_card:
            want, _ = step(on_cpu, serve.prefill_batch(bundle, tokens,
                                                       frames))
        want = want.float()
        differ, routed_tokens = routing_differences(on_card, off_card)
        err, rel = float((got - want).abs().max()), rel_l2(got, want)
        print("[parity-serve] " + json.dumps({
            "arch": cfg.name, "layers": cfg.num_layers, "prompt": prompt,
            "dtype": str(dtype), "launches": launched,
            "flash_gqa_routed": routed,
            "routing_tokens": routed_tokens,
            "routing_tokens_differ": differ,
            "max_abs_err": err, "rel_l2": rel,
            "logit_scale_max_abs": float(want.abs().max())}), flush=True)
        check(launched == prefill_launches(cfg) and routed == 0,
              f"{cfg.name}: kernels launched {launched}, want "
              f"{prefill_launches(cfg)}; {routed} calls routed to the plain "
              "path")
        check(bool(torch.isfinite(got).all()), "card logits not finite")
        if dtype == torch.float32:
            check(bool(((got - want).abs() <= PARITY_TOL
                        + PARITY_TOL * want.abs()).all()),
                  f"{cfg.name}: card vs cpu f32 prefill logits differ by "
                  f"{err} ({differ} of {routed_tokens} routed tokens "
                  "picked other experts)")
        else:
            check(rel <= PARITY_BF16_TOL, f"{cfg.name}: card vs cpu bf16 "
                  f"prefill logits {rel} apart in relative L2 ({differ} of "
                  f"{routed_tokens} routed tokens picked other experts)")


# ------------------------------------------------------------ moe dispatch
def moe_dispatch_phase(dev) -> list[dict]:
    """The MoE dispatch of the deepseek serve cell (``models/moe.dispatch``:
    one partition_pack call over B·E ids packing each entry's token
    number, then a gather of the token rows) at its prefill and decode
    shapes, with experts picked as the router picks them (6 distinct of
    64), against the plain per-group ``dispatch_indices``: every entry's
    slot, drops included, bit for bit; the buffer against the plain pack
    of the token rows on the card exactly; no host sync. Times: the pack
    call on the path, B calls of E partitions each, the plain version, the
    library yardstick (a stable sort and a gather), its memory bound; the
    whole dispatch; and the pack of the 4 KB token rows themselves (the
    route the dispatch does not take)."""
    cfg = get_config(MOE_ARCH)
    m, d = cfg.moe, cfg.d_model
    E, k = m.num_experts, m.top_k
    B = serve.CELLS[MOE_ARCH].batch
    recs = []
    for part, S in MOE_DISPATCH.items():
        C = MOE.expert_capacity(S, E, k, m.capacity_factor)
        rng = np.random.default_rng(S)
        h = torch.from_numpy(rng.standard_normal((B, S, d)).astype(
            np.float32)).to(dev).to(torch.bfloat16)
        experts = torch.topk(torch.from_numpy(rng.standard_normal(
            (B * S, E)).astype(np.float32)), k).indices.to(torch.int32)
        e_dev = experts.to(dev)
        before = K.launches
        buf, ids, slots = MOE.dispatch(h, e_dev, E, C)
        torch.cuda.synchronize()
        launched = K.launches - before
        per_group = experts.view(B, S * k)
        got_slots = slots.cpu().view(B, S * k)
        dropped = 0
        for b in range(B):
            sort_idx, dest, keep, _ = MOE.dispatch_indices(per_group[b], E,
                                                           C)
            order = sort_idx.long()
            got = torch.where(got_slots[b] < C,
                              per_group[b].long() * C + got_slots[b], E * C)
            check(torch.equal(got[order].int(), dest)
                  and torch.equal(got_slots[b][order] < C, keep),
                  f"moe dispatch {part}: group {b}'s slots differ from "
                  "dispatch_indices")
            dropped += int((~keep).sum())
        T = B * S * k
        rows = h.repeat_interleave(k, dim=1).reshape(T, d)
        (want_buf,), _, want_slots = K.plain_pack([rows], ids, B * E, C)
        check(torch.equal(buf.reshape(B * E, C, d), want_buf)
              and torch.equal(slots, want_slots),
              f"moe dispatch {part}: buffer differs from the plain pack")
        syncs = host_syncs(lambda: MOE.dispatch(h, e_dev, E, C))
        check(syncs == 0, f"moe dispatch {part}: {syncs} host syncs")
        token = torch.arange(1, B * S + 1, dtype=torch.int32,
                             device=dev).repeat_interleave(k)[:, None]
        ids_g, token_g = e_dev.view(B, S * k), token.view(B, S * k, 1)

        def kernel():
            K.pack([token], ids, B * E, C)

        def per_group_kernel():
            for b in range(B):
                K.pack([token_g[b]], ids_g[b], E, C)

        def plain():
            slot, _, keep = pp_ref.pack_indices(ids, B * E, C)
            pp_ref.pack_rows(token, ids, slot, keep, B * E, C)

        def library():
            token.index_select(0, torch.sort(ids, stable=True).indices)

        moved = pack_bytes([token], T, B * E, C)
        # the whole dispatch: ids and h read, buf and slots written
        dispatch_bytes = 8 * T + (B * S + B * E * C) * d * h.element_size()
        rec = {"case": part, "groups": B, "tokens": S, "entries": T,
               "n_parts": B * E, "capacity": C, "dropped": dropped,
               "launches": launched, "host_syncs": syncs,
               "kernel_ms": time_ms(kernel),
               "per_group_kernel_ms": time_ms(per_group_kernel),
               "plain_ms": time_ms(plain), "library_ms": time_ms(library),
               "bytes": moved, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
               "dispatch_ms": time_ms(lambda: MOE.dispatch(h, e_dev, E, C)),
               "dispatch_bound_ms": dispatch_bytes / HBM_BYTES_PER_S * 1e3,
               "row_pack_ms": time_ms(lambda: K.pack([rows], ids, B * E,
                                                     C))}
        print("[moe-dispatch] " + json.dumps(rec), flush=True)
        check(launched == 1, f"moe dispatch {part}: {launched} launches")
        recs.append(rec)
    return recs


def share_pack_phase(dev) -> list[dict]:
    """partition_pack on the expert share of ``SHARE_ARCH``'s cell, with
    ids as ``models/moe.dispatch`` lays them out: e·B + b for an entry of
    a held expert (0 .. SHARE_HELD - 1), -1 for the others (no partition),
    over B·SHARE_HELD partitions at the capacity of all the experts
    routed, experts picked as the router picks them (10 distinct of 72):
    kernel vs plain exactly, with times and the memory bound
    (``pack_case``); then the dispatch's slots equal the plain pack's,
    an entry not held at slot C (a drop)."""
    m = get_config(SHARE_ARCH).moe
    E, k = m.num_experts, m.top_k
    recs = []
    for B, S in SHARE_BATCHES:
        C = MOE.expert_capacity(S, E, k, m.capacity_factor)
        rng = np.random.default_rng(B * S)
        experts = torch.topk(torch.from_numpy(rng.standard_normal(
            (B * S, E)).astype(np.float32)), k).indices.to(torch.int32)
        experts = experts.to(dev)
        group = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
        e = experts.view(B, S * k)
        ids = torch.where(e < SHARE_HELD, e * B + group, -1).reshape(-1)
        token = torch.arange(1, B * S + 1, dtype=torch.int32,
                             device=dev).repeat_interleave(k)[:, None]
        label = f"share B={B} S={S} held {SHARE_HELD} of {E}"
        rec = pack_case(label, [token], ids, B * SHARE_HELD, C)
        h = torch.zeros(B, S, 8, dtype=torch.bfloat16, device=dev)
        _, _, slots = MOE.dispatch(h, experts, E, C, first=0,
                                   n_held=SHARE_HELD)
        _, _, want = K.plain_pack([token], ids, B * SHARE_HELD, C)
        check(torch.equal(slots, torch.where(want < 0, C, want)),
              f"{label}: the dispatch's slots differ from the plain pack")
        rec["entries_not_held"] = int((ids < 0).sum())
        print("[share-pack] " + json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def moe_combine_phase(dev) -> list[dict]:
    """The MoE combine (``kernels/moe_combine``) at ``COMBINE_CELLS``,
    experts picked as the router picks them (k distinct), ids and slots
    from ``models/moe.dispatch``, expert outputs and weights drawn in
    bf16: the kernel against its documented order in plain PyTorch
    (``ref.combine_in_order``) bit for bit and the plain combine within
    one bf16 step at the terms' scale (``ref.term_step``); one launch and
    one CUDA kernel a call (the functions a CUDA graph of the call holds,
    ``kernels/_graph.launched_functions``). Times: the kernel by events
    over back-to-back calls (warm: the 0.6-2 GB expert outputs exceed L2),
    its bytes bound (``ops.work`` at the kept entries) and share, and the
    plain combine."""
    recs = []
    for arch, B, S, held in COMBINE_CELLS:
        cfg = get_config(arch)
        m, d = cfg.moe, cfg.d_model
        E, k = m.num_experts, m.top_k
        held = held or E
        C = MOE.expert_capacity(S, E, k, m.capacity_factor)
        gen = torch.Generator(dev).manual_seed(B * S + E)
        experts = torch.topk(torch.randn(B * S, E, generator=gen,
                                         device=dev), k).indices.to(
            torch.int32)
        _, ids, slots = MOE.dispatch(
            torch.zeros(B, S, 8, dtype=torch.bfloat16, device=dev),
            experts, E, C, first=0, n_held=held)
        eout = torch.randn(held, B * C, d, generator=gen, device=dev).to(
            torch.bfloat16)
        w = torch.softmax(torch.randn(B * S, k, generator=gen, device=dev),
                          -1).to(torch.bfloat16)
        before = MCK.launches
        got = MC_OPS.moe_combine(eout, ids, slots, w, C, S, k)
        torch.cuda.synchronize()
        launched = MCK.launches - before
        in_order = torch.equal(got, mc_ref.combine_in_order(
            eout, ids, slots, w, C, S, k))
        plain = mc_ref.combine(eout, ids, slots, w, C, S, k)
        off = (got.float() - plain.float()).abs()
        step = mc_ref.term_step(eout, ids, slots, w, C, S, k)
        steps = torch.where(off > 0, off / step, 0)
        kept = int((slots < C).sum())
        _, moved = MC_OPS.work(B * S, k, d, kept, eout.element_size())
        label = f"{arch} B={B} S={S}"

        def kernel():
            MCK.combine(eout, ids, slots, w, C, S, k)

        functions = launched_functions(kernel)
        kernel_ms = time_ms(kernel)
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        rec = {"case": label, "tokens": B * S, "k": k, "d": d,
               "experts": E, "held": held, "capacity": C,
               "entries": B * S * k, "kept": kept, "launches": launched,
               "cuda_functions": functions,
               "in_order_bit_for_bit": in_order,
               "term_steps_from_plain_max": float(steps.max()),
               "elements_off_plain": int((off > 0).sum()),
               "elements": got.numel(),
               "kernel_ms": kernel_ms,
               "plain_ms": time_ms(lambda: mc_ref.combine(
                   eout, ids, slots, w, C, S, k), iters=5),
               "bytes": moved, "bound_ms": bound_ms,
               "bound_share": bound_ms / kernel_ms}
        print("[moe-combine] " + json.dumps(rec), flush=True)
        check(launched == 1 and functions == ["moe_combine_rows"],
              f"moe combine {label}: {launched} launches, CUDA functions "
              f"{functions} a call")
        check(in_order, f"moe combine {label}: the kernel differs from "
              "its documented order (ref.combine_in_order)")
        check(rec["term_steps_from_plain_max"] <= 1, f"moe combine "
              f"{label}: {rec['term_steps_from_plain_max']} bf16 steps at "
              "the terms' scale from the plain combine")
        recs.append(rec)
        del eout, plain, got, off, step, steps
        release()
    return recs


# ------------------------------------------------------------ flash kernel
def flash_inputs(B, S, H, Hkv, D, seed, dev, dtype, Dv=None, Sq=None,
                 q_scale=1.0):
    """q [B, Sq (default S), H, D] at ``q_scale`` times the unit normal,
    k [B, S, Hkv, D], v [B, S, Hkv, Dv]."""
    rng = np.random.default_rng(seed)
    arrs = (q_scale * rng.standard_normal((B, Sq or S, H, D)),
            rng.standard_normal((B, S, Hkv, D)),
            rng.standard_normal((B, S, Hkv, Dv or D)))
    return [torch.from_numpy(a.astype(np.float32)).to(dev).to(dtype)
            for a in arrs]


def flash_case(shape, dev, dtype, timed=False, dv=None, sq=None,
               scale=None) -> dict:
    """Kernel vs plain on the card: |o - want| <= tol + tol * |want|, tol
    2e-5 in f32, 2e-2 in bf16 (the Pallas kernel test's); ``dv``: v's head
    dim where it is not q's; ``sq``: the queries' length where it is not
    the keys' (no mask: cross attention; q then at 3 times the unit scale,
    so that the softmax is sharp and the outputs O(1): at unit scale over
    1500 keys they are about 0.03, and the tolerance would pass an output
    10 % off); ``scale``: the softmax scale where it is not 1/sqrt(D) (q
    then at 1/(scale·sqrt(D)) times its scale, so that the scores spread
    as at the default; a launch that left the scale out would put them
    sqrt(D) times wider). Each case checks that its tolerance fails an output 10 %
    off. The record names the body that ran (``flash_gqa.body``), held
    against the CUDA functions a CUDA graph of the call holds, as the
    driver recorded them (``kernels/_graph.launched_functions``), and
    against those the source's dispatch says it launched
    (``flash_gqa.last_launch``); a wgmma call with no mask, its kv splits.
    Timed, also the library yardstick
    (``scaled_dot_product_attention`` with ``enable_gqa``, the window as
    an explicit mask) and the kernels it ran (which name its backend)."""
    B, S, H, Hkv, D, causal, window, kv_head = shape
    Sq = sq or S
    q_scale = 1.0 if causal or window else 3.0
    if scale is not None:
        q_scale /= scale * math.sqrt(D)
    q, k, v = flash_inputs(B, S, H, Hkv, D, S + H, dev, dtype, dv, Sq,
                           q_scale)
    m = torch.tensor(kv_head if kv_head is not None
                     else [h // (H // Hkv) for h in range(H)], device=dev)

    def plain():
        return attention_ref(q, k.index_select(2, m), v.index_select(2, m),
                             causal=causal, window=window, scale=scale)

    def kernel():
        return FK.flash_gqa(q, k, v, causal=causal, window=window,
                            kv_head=kv_head, scale=scale)

    o = kernel()
    torch.cuda.synchronize()
    ran = FK.last_launch()
    graph = launched_functions(kernel)
    want = plain()
    tol = FLASH_TOL[dtype]
    label = (f"{shape[:7]}{f' Sq={sq}' if sq else ''}"
             f"{f' Dv={dv}' if dv else ''}"
             f"{' padded map' if kv_head else ''}"
             f"{f' scale={scale}' if scale else ''} {dtype}")
    err = float((o.float() - want.float()).abs().max())
    check(bool(torch.isfinite(o).all()), f"flash {label}: not finite")
    check(bool(((o.float() - want.float()).abs()
                <= tol + tol * want.float().abs()).all()),
          f"flash {label}: differs from the plain version by {err}")
    check(bool((0.1 * want.float().abs()
                > tol + tol * want.float().abs()).any()),
          f"flash {label}: the tolerance would pass an output 10 % off")
    rec = {"case": label, "max_abs_err": err,
           "body": FK.body(q.shape, v.shape, dtype, causal=causal,
                           window=window), "cuda_functions": graph}
    body_fns = FK.BODY_KERNELS[rec["body"]]
    check(ran[:1] == body_fns[:1] and set(ran) <= set(body_fns),
          f"flash {label}: the dispatch launched {ran}, not the "
          f"{rec['body']} body's {body_fns}")
    check(sorted(graph) == sorted(ran),
          f"flash {label}: a CUDA graph of the call holds {graph}, the "
          f"dispatch says it launched {ran}")
    if rec["body"] == "wgmma" and not causal and not window:
        # a wgmma call's kv split: the items run whole and the splits of
        # the others (those past its last full wave of blocks)
        whole, n_split, _ = FK.wgmma_split_plan(
            q.shape, v.shape, torch.cuda.get_device_properties(
                dev).multi_processor_count)
        rec.update(whole_items=whole, kv_splits=n_split)
    if timed:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if kv_head is not None:
            # a head map other than h // (H / Hkv) is no GQA layout that
            # the library takes: it reads k and v expanded to the H query
            # heads beforehand, outside the timing
            kt, vt = kt.index_select(1, m), vt.index_select(1, m)
        mask = None
        if window:
            i = torch.arange(S, device=dev)
            mask = ((i[None] <= i[:, None]) | (not causal)) \
                & (i[None] > i[:, None] - window)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and not window,
                enable_gqa=True, scale=scale)

        lib_err = float((library().transpose(1, 2).float()
                         - want.float()).abs().max())
        check(lib_err <= tol + tol * float(want.float().abs().max()),
              f"flash {label}: the library yardstick computes something "
              f"else ({lib_err})")
        flops, nbytes = FLASH_OPS.work(q.shape, k.shape, v.shape,
                                       causal=causal, window=window,
                                       elem_bytes=q.element_size())
        peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
        rec.update(kernel_ms=time_ms(kernel), plain_ms=time_ms(plain),
                   library_ms=time_ms(library), library_max_abs_err=lib_err,
                   library_backend=sdpa_backend(library),
                   flops=flops, bytes=nbytes,
                   bound_ms=max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3,
                   bound_by="operations" if flops / peak
                   >= nbytes / HBM_BYTES_PER_S else "bytes")
    print("[flash] " + json.dumps(rec), flush=True)
    return rec


def sdpa_backend(call) -> str:
    """The backend scaled_dot_product_attention's default dispatch ran for
    ``call``: the one whose output, run alone, equals the default's bit
    for bit (a backend that refuses the shapes raises and is passed
    over)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    want = call()
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                got = call()
        except RuntimeError:
            continue
        if torch.equal(got, want):
            return backend.name
    return "none of the four alone"


def flash_phase(dev) -> tuple[dict, dict, dict, float]:
    """-> (the main shape's record in the serve path's bf16, MLA's prefill
    shape's in bf16, the records of this slice's shapes in bf16 by name
    (head dim 256 causal and windowed, whisper's cross attention at the
    prefill and a decode step, its encoder, smollm-135m's train shape,
    granite's prefill at its softmax scale),
    the largest error of any case in either dtype)."""
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain version in
    torch.backends.cudnn.allow_tf32 = False           # full f32
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FLASH_CASES:
            err = max(err, flash_case(shape, dev, dtype)["max_abs_err"])
    err = max(err, flash_case(FLASH_MAIN, dev, torch.float32,
                              timed=True)["max_abs_err"])
    main_rec = flash_case(FLASH_MAIN, dev, torch.bfloat16, timed=True)
    for dtype in (torch.float32, torch.bfloat16):
        err = max(err, flash_case(FLASH_MLA_EDGE, dev, dtype,
                                  dv=MLA_DV)["max_abs_err"])
    err = max(err, flash_case(FLASH_MLA, dev, torch.float32,
                              dv=MLA_DV)["max_abs_err"])
    mla_rec = flash_case(FLASH_MLA, dev, torch.bfloat16, timed=True,
                         dv=MLA_DV)
    new = {}
    for name, (shape, sq) in FLASH_NEW.items():
        f32 = flash_case(shape, dev, torch.float32, timed=True, sq=sq)
        new[name] = flash_case(shape, dev, torch.bfloat16, timed=True, sq=sq)
        new[name]["f32"] = {key: f32[key] for key in (
            "body", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err")}
        err = max(err, f32["max_abs_err"], new[name]["max_abs_err"])
    f32 = flash_case(FLASH_GRANITE, dev, torch.float32, scale=GRANITE_SCALE)
    new["granite_prefill"] = flash_case(FLASH_GRANITE, dev, torch.bfloat16,
                                        timed=True, scale=GRANITE_SCALE)
    new["granite_prefill"]["f32"] = {key: f32[key] for key in (
        "body", "max_abs_err")}
    err = max(err, f32["max_abs_err"],
              new["granite_prefill"]["max_abs_err"])
    return main_rec, mla_rec, new, max(err, main_rec["max_abs_err"],
                                       mla_rec["max_abs_err"])


# ------------------------------------------------------------------- train
def train_batch(cfg, B: int, S: int, dev) -> dict:
    """A language-model batch of B x S tokens drawn from the seed: the
    targets are the tokens shifted by one."""
    seq = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)).to(dev)
    return {"tokens": seq[:, :-1].contiguous(),
            "targets": seq[:, 1:].contiguous(),
            "mask": torch.ones(B, S, dtype=torch.int32, device=dev)}


def train_grad_parity(dev):
    """One train step's loss and gradients of smollm-135m at full width
    and depth (30 layers, f32 parameters and compute, remat as configured,
    TRAIN_PARITY_BATCH x TRAIN_PARITY_SEQ tokens) on the card, through
    flash_gqa, against the CPU's (the reference's attention algorithm):
    the loss within TRAIN_LOSS_TOL relative, every gradient leaf finite,
    nonzero on the CPU and within GRAD_TOL of its largest entry there, and
    flash_gqa launched as ``train_launches`` works out, none routed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(SMOLLM_ARCH).replace(param_dtype=torch.float32,
                                          compute_dtype=torch.float32)
    bundle = build_model(cfg)
    params = init_params(bundle.param_defs,
                         torch.Generator().manual_seed(SEED), "cpu")
    batch = train_batch(cfg, TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ, "cpu")
    t0 = time.perf_counter()
    g_cpu, m_cpu = grads_of(bundle.loss_fn, params, batch)
    cpu_s = time.perf_counter() - t0
    move = lambda t: tree_map(lambda x: x.to(dev), t,  # noqa: E731
                              is_leaf=torch.is_tensor)
    before, routed = FK.launches, FK.routed
    g_card, m_card = grads_of(bundle.loss_fn, move(params), move(batch))
    torch.cuda.synchronize()
    launched, routed = FK.launches - before, FK.routed - routed
    want = train_launches(cfg)["flash_gqa"]
    loss = float(m_card["loss"]), float(m_cpu["loss"])
    errs, scale, finite = [], [], True
    for a, b in zip(tree_leaves(g_card, torch.is_tensor),
                    tree_leaves(g_cpu, torch.is_tensor), strict=True):
        a = a.cpu()
        finite &= bool(torch.isfinite(a).all())
        errs.append(float((a - b).abs().max()))
        scale.append(float(b.abs().max()))
    rel = [e / m for e, m in zip(errs, scale) if m > 0]
    print("[train parity] " + json.dumps({
        "arch": SMOLLM_ARCH, "layers": cfg.num_layers,
        "batch": TRAIN_PARITY_BATCH, "seq": TRAIN_PARITY_SEQ,
        "remat": cfg.remat, "loss_card_cpu": loss, "leaves": len(errs),
        "max_rel_grad_err": max(rel, default=None), "cpu_s": cpu_s,
        "flash_gqa_launches": launched, "expected": want,
        "routed": routed}), flush=True)
    check(abs(loss[0] - loss[1]) <= TRAIN_LOSS_TOL * abs(loss[1]),
          f"train loss on the card {loss[0]}, on the CPU {loss[1]}")
    check(finite, "card train gradients not finite")
    check(len(rel) == len(errs), f"{len(errs) - len(rel)} gradient leaves "
          "are zero on the CPU")
    check(all(e <= GRAD_TOL * m for e, m in zip(errs, scale)),
          f"card train gradients differ from the CPU's: {max(rel)} of the "
          "largest entry")
    check(launched == want and routed == 0, f"train parity: {launched} "
          f"flash_gqa launches, want {want}; {routed} routed")


def train_phase(dev, arch: str, layers: int | None) -> dict:
    """``TRAIN_STEPS`` train steps of ``arch`` at full width (``layers``
    deep where given) on one batch drawn from the seed, through
    launch/steps.make_train_step: f32 parameters and AdamW state, bf16
    compute. Checks the loss finite at every step and lower at the last
    step than at the first, the first step's gradient finite and nonzero
    in every leaf, every parameter leaf moved, the launches
    exactly ``train_launches`` a step and 0 routed calls. Prints ms a step
    (host clock around a synchronized step; the mean of steps 2 and 3:
    step 1 allocates, step 4 runs under the profiler), tokens/s, peak
    memory and the profiled step's device time. -> the launches."""
    cfg = get_config(arch).replace(param_dtype=torch.float32,
                                   compute_dtype=torch.bfloat16)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    bundle = build_model(cfg)
    opt = make_optimizer("adamw", lr=TRAIN_LR)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(bundle, opt, torch.Generator(dev).manual_seed(
        SEED), dev)
    batch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, dev)
    leaves = tree_leaves(state["params"], is_leaf=torch.is_tensor)
    first = [t.view(-1)[:4096].clone() for t in leaves]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step_fn, _ = make_train_step(bundle, opt)
    zero_counts()
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        profiled = i == TRAIN_STEPS - 1
        with (torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext()) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        if i == 0:
            # AdamW's first moment after one step is (1 - b1)·g: the
            # leaves whose gradient has a non-finite entry or none but 0
            # (aminmax reduces a 2.7 B tree without a copy of a leaf)
            span = [tuple(map(float, torch.aminmax(t.view(-1))))
                    for t in tree_leaves(state["opt"]["m"], torch.is_tensor)]
            bad_grads = [j for j, (lo, hi) in enumerate(span)
                         if not (np.isfinite(lo) and np.isfinite(hi))
                         or lo == hi == 0]
    launched, routed = counts(), FK.routed
    want = {k: v * TRAIN_STEPS for k, v in train_launches(cfg).items()}
    moved = sum(not torch.equal(a, t.view(-1)[:4096])
                for a, t in zip(first, leaves))
    ms = (step_ms[1] + step_ms[2]) / 2
    kernels = PQ.device_kernels(prof)
    busy = PQ.busy_s(prof.events())
    rec = {"arch": arch, "layers": cfg.num_layers,
           "params": sum(t.numel() for t in leaves),
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "optimizer": "adamw",
           "lr": TRAIN_LR, "remat": cfg.remat, "losses": losses,
           "step_ms": step_ms, "ms_a_step": ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms * 1e-3),
           "init_s": init_s, "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": launched, "expected_launches": want, "routed": routed,
           "leaves_moved": moved, "leaves": len(leaves),
           "first_step_bad_grad_leaves": bad_grads,
           "profiled_step": {
               "wall_ms": step_ms[-1], "device_busy_ms": busy * 1e3,
               "idle_share": 1 - busy * 1e3 / step_ms[-1],
               "kernels": sum(n for key, _, n in kernels if not
                              key.startswith(("Memcpy", "Memset")))}}
    for label, prefix in KERNELS.items():
        mine = [(k_ms, n) for key, k_ms, n in kernels
                if PQ.is_kernel(key, prefix)]
        rec["profiled_step"][f"{label}_device_ms"] = sum(m for m, _ in mine)
        rec["profiled_step"][f"{label}_cuda_launches"] = sum(
            n for _, n in mine)
    rec["profiled_step"]["top_kernels_ms"] = [
        {"name": key[:80], "ms": k_ms, "count": n}
        for key, k_ms, n in kernels[:8]]
    print("[train] " + json.dumps(rec), flush=True)
    check(all(np.isfinite(x) for x in losses),
          f"{arch}: a train loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"{arch}: the loss did not fall on one "
          f"batch over {TRAIN_STEPS} steps: {losses}")
    check(not bad_grads, f"{arch}: the first step's gradient is not "
          f"finite or is all 0 in leaves {bad_grads} of {len(leaves)}")
    check(moved == len(leaves), f"{arch}: {len(leaves) - moved} of "
          f"{len(leaves)} parameter leaves did not move")
    check(launched == want, f"{arch}: train launches {launched}, want "
          f"{want}")
    check(routed == 0, f"{arch}: {routed} attention calls routed to the "
          "plain path")
    return launched


# ----------------------------------------------------------------- elastic
def peak_rss() -> int:
    """The process's peak resident set in bytes since it started
    (getrusage)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def instrumented(trainer: ElasticTrainer) -> dict:
    """Wrap the trainer's step, save and restore with synchronized host
    clocks; -> the lists they fill: each step's ms, each save's (s, won,
    virtual end), each restore's (s, virtual end); and a copy on the card
    of the state the last save wrote ("last_state", its leaves)."""
    rec = {"step_ms": [], "saves": [], "restores": []}
    step_fn, ckpt = trainer.step_fn, trainer.ckpt
    save, restore = ckpt.save, ckpt.restore_state

    def step(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def saving(state, step_no, now=0.0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        won, end = save(state, step_no, now)
        rec["saves"].append((time.perf_counter() - t0, won, end))
        if step_no == trainer.job.total_steps:
            rec["last_state"] = [t.clone() for t in tree_leaves(
                state, torch.is_tensor)]
        return won, end

    def restoring(template, step_no, now=0.0):
        t0 = time.perf_counter()
        state, end = restore(template, step_no, now)
        rec["restores"].append((time.perf_counter() - t0, end))
        return state, end

    trainer.step_fn, ckpt.save, ckpt.restore_state = step, saving, restoring
    return rec


def elastic_run(cfg, dev, fails) -> tuple[ElasticTrainer, dict]:
    """One ElasticTrainer run of ELASTIC_JOB on the card over a fresh
    store, a worker dying once at each (task, step) of ``fails``. -> (the
    trainer, its record: losses, timings, launches, store counts)."""
    store = ObjectStore(StoreConfig(seed=0, simulate_visibility_lag=False))
    left = set(fails)

    def hook(task, step):
        if (task, step) in left:
            left.discard((task, step))
            return True
        return False
    trainer = ElasticTrainer(build_model(cfg), store, ELASTIC_JOB, seed=SEED,
                             failure_hook=hook, device=dev)
    rec = instrumented(trainer)
    zero_counts()
    t0 = time.perf_counter()
    log = trainer.run()
    torch.cuda.synchronize()
    rec.update(wall_s=time.perf_counter() - t0, log=log, launches=counts(),
               routed=FK.routed, puts=store.stats.puts,
               gets=store.stats.gets, deaths=len(fails) - len(left))
    return trainer, rec


def elastic_phase(dev, arch: str, layers: int | None) -> dict:
    """The elastic trainer on the card (``ELASTIC_JOB``): a clean run, then
    a run whose workers die at ``ELASTIC_FAILS``, each over its own store
    (the clean one freed first), then a third trainer over the finished
    store. Checks the committed steps [2, 4, 6, 8] in both runs, the
    losses finite and equal at rtol 0, atol 0, each kernel launched
    ``train_launches`` times a step the run actually ran (replayed steps
    included), 0 routed, the last checkpoint restored on the CPU equal bit
    for bit to the state the card saved, and the third trainer committing
    nothing (no PUT). -> the launches of both runs."""
    cfg = get_config(arch).replace(param_dtype=torch.float32,
                                   compute_dtype=torch.bfloat16)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    job, t_phase = ELASTIC_JOB, time.perf_counter()
    rss_before = peak_rss()
    trainer, clean = elastic_run(cfg, dev, ())
    trainer.store.delete_all()
    del trainer, clean["last_state"]
    release()
    trainer, recov = elastic_run(cfg, dev, ELASTIC_FAILS)
    store, last = trainer.store, job.total_steps
    prefix = f"ckpt/{cfg.name}/{last}/"
    ckpt_bytes = sum(store.size(k) for k in store.keys()
                     if k.startswith(prefix) and not k.endswith(".dw"))
    # the card's last checkpoint restored on the CPU, against the state the
    # card saved, bit for bit
    t0 = time.perf_counter()
    state, _ = CheckpointManager(store, cfg.name, n_shards=job.ckpt_shards
                                 ).restore_state(trainer.state_defs, last)
    cpu_same = all(
        a.device.type == "cpu" and a.dtype == b.dtype and torch.equal(
            a.reshape(-1).view(torch.uint8), b.cpu().reshape(-1).view(
                torch.uint8))
        for a, b in zip(tree_leaves(state, torch.is_tensor),
                        recov.pop("last_state"), strict=True))
    cpu_check_s = time.perf_counter() - t0
    del state
    # a third trainer over the finished store
    puts = store.stats.puts
    third = ElasticTrainer(trainer.bundle, store, job, seed=SEED, device=dev)
    third_log = third.run()
    third_puts = store.stats.puts - puts
    store.delete_all()
    del trainer, third, store
    release()
    per_step = train_launches(cfg)
    runs = {"clean": clean, "recovered": recov}
    out = {"arch": arch, "layers": cfg.num_layers, "job": dataclasses.asdict(
        job), "fails": ELASTIC_FAILS, "checkpoint_bytes": ckpt_bytes,
        "cpu_restore_same_bytes": cpu_same, "cpu_check_s": cpu_check_s,
        "third_run_log": third_log, "third_run_puts": third_puts,
        "peak_rss_before_bytes": rss_before,
        "peak_rss_after_bytes": peak_rss()}
    for name, r in runs.items():
        steps = len(r["step_ms"])
        r["expected_launches"] = {k: v * steps for k, v in per_step.items()}
        out[name] = {
            "steps": [m["step"] for m in r["log"]],
            "losses": [m["loss"] for m in r["log"]],
            "deaths": r["deaths"], "steps_run": steps,
            "ms_a_step": sum(r["step_ms"]) / steps,
            "step_ms_min_max": [min(r["step_ms"]), max(r["step_ms"])],
            "save_s": [s for s, _, _ in r["saves"]],
            "save_virtual_end_s": [e for _, _, e in r["saves"]],
            "restore_s": [s for s, _ in r["restores"]],
            "restore_virtual_end_s": [e for _, e in r["restores"]],
            "store_puts": r["puts"], "store_gets": r["gets"],
            "launches": r["launches"],
            "expected_launches": r["expected_launches"],
            "routed": r["routed"], "wall_s": r["wall_s"]}
    out["phase_s"] = time.perf_counter() - t_phase
    print("[elastic] " + json.dumps(out), flush=True)
    committed = [job.steps_per_task * (i + 1) for i in range(
        job.total_steps // job.steps_per_task)]
    for name, r in runs.items():
        check([m["step"] for m in r["log"]] == committed,
              f"{arch} {name}: committed steps "
              f"{[m['step'] for m in r['log']]}, want {committed}")
        check(all(np.isfinite(m["loss"]) for m in r["log"]),
              f"{arch} {name}: a loss is not finite: {r['log']}")
        check(r["launches"] == r["expected_launches"] and r["routed"] == 0,
              f"{arch} {name}: launches {r['launches']}, want "
              f"{r['expected_launches']}; {r['routed']} routed")
    check(recov["deaths"] == len(ELASTIC_FAILS), f"{arch}: "
          f"{recov['deaths']} of {len(ELASTIC_FAILS)} deaths injected")
    check(out["clean"]["losses"] == out["recovered"]["losses"],
          f"{arch}: the recovered run's losses {out['recovered']['losses']}"
          f" differ from the clean run's {out['clean']['losses']}")
    check(cpu_same, f"{arch}: the checkpoint of step {last} restored on "
          "the CPU differs from the state the card saved")
    check(third_log == [] and third_puts == 0, f"{arch}: the trainer over "
          f"the finished store committed {third_log}, {third_puts} PUTs")
    return {name: r["launches"] for name, r in runs.items()}


# ------------------------------------------------------------------ dryrun
def dryrun_phase(dev, card: str) -> dict:
    """Step 1: for each of DRYRUN_STEPS, ``launch/dryrun.card_check`` (a
    warm-up, two timed steps and one analyzed step on the card, then the
    same step analyzed on meta tensors): the same FLOPs exactly, HBM
    bytes within DRYRUN_BYTES_TOL, the meta peak within DRYRUN_PEAK_TOL
    of ``max_memory_allocated`` during the analyzed step, and so the
    step's own peak above its arguments (above what the card held before
    it), the same kernel calls, each kernel launched ``train_launches``
    (``prefill_launches``) times a step on the card and 0 attention calls
    routed. One line a step with model FLOPs, analyzed FLOPs, the useful
    ratio, the measured step time and model FLOPs / step time / the bf16
    peak (printed, not gated). Step 2: DRYRUN_CELLS through
    ``launch/dryrun.run_cell`` on the host (records under dryrun_out/),
    one line a cell, nothing launched or allocated on the card. -> the
    kernels' launches by step."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DR
    launched = {}
    for arch, kind, layers in DRYRUN_STEPS:
        t0 = time.perf_counter()
        print(f"[{arch}] allocated before its dryrun step: {release()} "
              "bytes", flush=True)
        cfg = get_config(arch).replace(
            compute_dtype=torch.bfloat16,
            param_dtype=torch.float32 if kind == "train" else torch.bfloat16)
        if layers is not None:
            cfg = cfg.replace(num_layers=layers)
        zero_counts()
        r = DR.card_check(cfg, ShapeConfig(kind, TRAIN_SEQ, TRAIN_BATCH,
                                           kind), dev, seed=SEED)
        n = launched[f"dryrun {arch} {kind}"] = counts()
        routed = FK.routed
        per_step = (train_launches if kind == "train" else
                    prefill_launches)(cfg)
        want = {k: v * r["card_steps"] for k, v in per_step.items()}
        c, m = r["card"], r["meta"]
        # what the step itself allocates above what it was handed: on the
        # card above all that was allocated before it, on meta above its
        # arguments
        own_card = r["card_peak_bytes"] - r["allocated_before"]
        own_meta = m["peak_bytes"] - m["argument_bytes"]
        rec = {"card": card, "arch": arch, "kind": kind,
               "layers": cfg.num_layers, "batch": TRAIN_BATCH,
               "seq": TRAIN_SEQ, "model_flops": r["model_flops"],
               "flops_card": c["flops"], "flops_meta": m["flops"],
               "useful_flops_ratio": r["model_flops"] / m["flops"],
               "bytes_card": c["memory_bytes"],
               "bytes_meta": m["memory_bytes"],
               "bytes_rel_gap": abs(c["memory_bytes"] - m["memory_bytes"])
               / m["memory_bytes"],
               "kernel_calls_card": c["kernel_calls"],
               "kernel_calls_meta": m["kernel_calls"],
               "argument_bytes_card": c["argument_bytes"],
               "argument_bytes_meta": m["argument_bytes"],
               "allocated_before": r["allocated_before"],
               "peak_card": r["card_peak_bytes"], "peak_meta": m["peak_bytes"],
               "peak_rel_gap": (m["peak_bytes"] - r["card_peak_bytes"])
               / r["card_peak_bytes"],
               "step_peak_card": own_card, "step_peak_meta": own_meta,
               "step_peak_rel_gap": (own_meta - own_card) / own_card,
               "step_ms": r["step_s"] * 1e3,
               "model_flops_share_of_bf16_peak":
                   r["model_flops"] / r["step_s"] / BF16_FLOP_PER_S,
               "launches": n, "expected_launches": want, "routed": routed,
               "s": time.perf_counter() - t0}
        print("[dryrun] " + json.dumps(rec), flush=True)
        if kind == "train":
            print("[train step ms] " + json.dumps({
                "card": card, "arch": arch, "layers": cfg.num_layers,
                "step_ms": rec["step_ms"],
                "step_ms_before": TRAIN_MS_BEFORE[arch]}), flush=True)
        what = f"dryrun {arch} {kind}"
        check(c["flops"] == m["flops"], f"{what}: {c['flops']} FLOPs on "
              f"the card, {m['flops']} on meta")
        check(rec["bytes_rel_gap"] <= DRYRUN_BYTES_TOL,
              f"{what}: HBM bytes {c['memory_bytes']} on the card, "
              f"{m['memory_bytes']} on meta")
        check(abs(rec["peak_rel_gap"]) <= DRYRUN_PEAK_TOL,
              f"{what}: meta peak {m['peak_bytes']}, max_memory_allocated "
              f"{r['card_peak_bytes']}")
        check(abs(rec["step_peak_rel_gap"]) <= DRYRUN_PEAK_TOL,
              f"{what}: the step's own peak {own_meta} on meta (its peak "
              f"less its arguments), {own_card} on the card "
              "(max_memory_allocated less memory_allocated before it)")
        check(c["kernel_calls"] == m["kernel_calls"]
              and sum(c["kernel_calls"].values()) > 0,
              f"{what}: kernel calls {c['kernel_calls']} on the card, "
              f"{m['kernel_calls']} on meta")
        check(n == want and routed == 0, f"{what}: launches {n}, want "
              f"{want} ({r['card_steps']} steps on the card); {routed} "
              "attention calls routed to the plain path")
    workers = start_mesh_workers()
    before = torch.cuda.memory_allocated()
    for arch, shape, mesh in DRYRUN_CELLS:
        t0 = time.perf_counter()
        zero_counts()
        rec = DR.run_cell(arch, shape, mesh)
        print(f"[dryrun cell] {arch} x {shape} x {mesh}: {DR.line(rec)}",
              flush=True)
        print("[dryrun cell] " + json.dumps({"card": card, **rec}),
              flush=True)
        check(all(v == 0 for v in counts().values())
              and torch.cuda.memory_allocated() == before,
              f"dryrun cell {arch} x {shape}: launched {counts()} or "
              "allocated on the card")
        check(rec["cost"]["flops_per_device"] > 0
              and rec["roofline"]["step_time_lower_bound_s"] > 0,
              f"dryrun cell {arch} x {shape}: an empty analysis")
        if (arch, shape, mesh) == ("glm4-9b", "train_4k", "single"):
            hold_glm4_train_4k(rec)
        print(f"[phase] dryrun cell {arch} x {shape} x {mesh}: "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    hold_mesh_cells(workers)
    return launched


def hold_glm4_train_4k(rec: dict) -> None:
    """glm4-9b x train_4k x single at full width and depth: FLOPs and
    collective bytes a device within the mesh tests' tolerances of
    GLM4_TRAIN_4K, the sandbox's count (the weights gathered at use, not
    the batch: a batch gather over "data" reads 3.5x the FLOPs and 8.8x
    the bytes)."""
    import _torch_mesh as TM
    flops = rec["cost"]["flops_per_device"]
    coll = rec["collectives"]["total_bytes"]
    print("[dryrun glm4 train_4k] " + json.dumps({
        "torch": torch.__version__, "flops_per_device": flops,
        "sandbox_flops": GLM4_TRAIN_4K["flops"],
        "flops_rel_gap": flops / GLM4_TRAIN_4K["flops"] - 1,
        "collective_bytes_by_kind": rec["collectives"]["bytes_by_kind"],
        "collective_bytes": coll,
        "sandbox_collective_bytes": GLM4_TRAIN_4K["collective_bytes"],
        "useful_flops_ratio": rec["roofline"]["useful_flops_ratio"],
        "fallback_ops": rec["fallback_ops"]}), flush=True)
    check(abs(flops / GLM4_TRAIN_4K["flops"] - 1) <= TM.FLOPS_TOL,
          f"glm4-9b x train_4k x single: {flops} FLOPs a device, the "
          f"sandbox's torch {GLM4_TRAIN_4K['torch']} {GLM4_TRAIN_4K['flops']}")
    check(abs(coll / GLM4_TRAIN_4K["collective_bytes"] - 1) <= TM.COLL_TOL,
          f"glm4-9b x train_4k x single: {coll} collective bytes a device, "
          f"the sandbox's {GLM4_TRAIN_4K['collective_bytes']}")


def start_mesh_workers() -> list:
    """One ``--mesh-worker`` process an arch that the reference has (each
    starts its own fake process group), all at once: -> [(arch, Popen)]."""
    import _torch_mesh as TM
    from repro_torch.configs.base import registry
    return [(arch, subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-worker",
         arch], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for arch in sorted(registry()) if arch not in TM.NO_REFERENCE]


def mesh_worker(arch: str) -> None:
    """Every cell of the mesh tests for ``arch``: a smoke step under
    ``launch/dryrun.lower_cell`` on the fake 2x4 or 2x2x2 mesh, and the
    one-device steps of ``tests/test_torch_dryrun_onedevice.py`` (no mesh,
    meta tensors), one JSON line a cell with its FLOPs and collective
    bytes a device (reduce-scatters priced as the reference's CPU backend
    lowers them, ``_torch_mesh.cpu_lowered``; none on one device)."""
    import _torch_mesh as TM
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_mesh
    meshes = {n: make_mesh(*spec) for n, spec in TM.MESHES.items()}
    cfg = smoke_config(arch).replace(num_layers=TM.LAYERS.get(arch, 2))
    if cfg.family == "audio":
        cfg = cfg.replace(encoder_layers=1)
    for kind, mesh in TM.CELLS + TM.ONE_DEVICE_CELLS:
        t0 = time.perf_counter()
        ana, _ = lower_cell(arch, ShapeConfig("smoke", TM.S, TM.B, kind),
                            meshes.get(mesh), cfg=cfg, record_ops=True)
        print(json.dumps({
            "cell": f"{arch}:{kind}:{mesh}", "flops": ana["flops"],
            "collective_bytes": TM.cpu_lowered(ana),
            "collective_bytes_by_kind": ana["collective_bytes_by_kind"],
            "fallback_ops": ana["fallback_ops"],
            "s": time.perf_counter() - t0}), flush=True)


def hold_mesh_cells(workers: list) -> None:
    """Each smoke mesh cell and one-device step within the tests'
    tolerances of the reference's counts (a one-device step: its FLOPs),
    but the open cells the tests list in KNOWN_FAULTS, which are printed
    with their reason and held instead to the FLOPs the CPU tests' torch
    release reads (``_torch_mesh.OPEN_CELL_FLOPS``), since the port
    states their layouts."""
    import _torch_mesh as TM
    t0 = time.perf_counter()
    ref = json.loads(TM.REFERENCE.read_text())["cells"]
    held = faults = 0
    for arch, proc in workers:
        out, err = proc.communicate(timeout=MESH_WORKER_TIMEOUT_S)
        check(proc.returncode == 0,
              f"mesh worker {arch}: exit {proc.returncode}\n{err[-3000:]}")
        for line in out.splitlines():
            got = json.loads(line)
            want = ref[got["cell"]]
            rec = {**got, "reference_flops": want["flops"],
                   "reference_collective_bytes":
                       want["collective_total_bytes"],
                   "flops_rel_gap": got["flops"] / want["flops"] - 1,
                   "collective_ratio": got["collective_bytes"]
                   / want["collective_total_bytes"]
                   if want["collective_total_bytes"] else None}
            key = tuple(got["cell"].split(":"))
            one_device = key[2] == "1"
            ok = (abs(rec["flops_rel_gap"]) <= TM.FLOPS_TOL
                  and (one_device or abs(rec["collective_ratio"] - 1)
                       <= TM.COLL_TOL))
            if key in TM.KNOWN_FAULTS:
                rec["known_fault"] = TM.KNOWN_FAULTS[key]
                cpu = TM.OPEN_CELL_FLOPS[key]
                rec["cpu_tests_flops"] = cpu
                rec["flops_rel_gap_to_cpu_tests"] = got["flops"] / cpu - 1
                check(abs(rec["flops_rel_gap_to_cpu_tests"]) <= TM.FLOPS_TOL,
                      f"open mesh cell {got['cell']}: {got['flops']} FLOPs "
                      f"a device on torch {torch.__version__}, {cpu} in "
                      "the CPU tests")
                faults += 1
            else:
                check(ok, f"mesh cell {got['cell']}: {json.dumps(rec)}")
                held += 1
            rec["within"] = ok
            print("[dryrun mesh] " + json.dumps(rec), flush=True)
    check(held + faults == len(ref), f"{held + faults} mesh cells and "
          f"one-device steps run, {len(ref)} in the reference")
    print(f"[phase] dryrun mesh cells: {held} held, {faults} known faults "
          "held to the CPU tests' FLOPs, "
          f"{time.perf_counter() - t0:.3f} s waited", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    phase("card", t0)

    t0 = time.perf_counter()
    built = _build.build()
    for name in built:
        print(f"[build] {name}\n{_build.build_log(name)}", flush=True)
    for name in built:
        tc = _build.tensor_core_ops(name) or {}
        for fn, res in sorted(_build.resources(name).items()):
            print("[resources] " + json.dumps({
                "kernel": name, "function": fn, **res,
                "tensor_core_instructions": tc.get(fn)}), flush=True)
    phase("build", t0)

    t0 = time.perf_counter()
    coord, tables = make_engine(sf=SF, seed=SEED, device="cuda",
                                target_bytes=TARGET_BYTES, compute_scale=1.0,
                                executor_workers=1)
    splits = coord.base_splits["lineitem"]
    split_rows = max(len(decode_object(coord.store.get(k), ["l_orderkey"]))
                     for k in splits)
    print(f"[setup] lineitem {len(tables['lineitem'])} rows in "
          f"{len(splits)} splits, largest {split_rows} rows", flush=True)
    phase("engine set-up", t0)

    t0 = time.perf_counter()
    recs = kernel_phase(tables, split_rows, dev)
    main_rec = recs[0]
    phase("kernel", t0)

    t0 = time.perf_counter()
    zero_counts()                                # the query path's count
    launches, expected = query_phase(coord, tables)
    check(FK.launches == SK.launches == 0,
          f"serve kernels launched on the query path: {counts()}")
    phase("query", t0)

    t0 = time.perf_counter()
    parity_phase()
    phase("parity", t0)

    t_new = t0 = time.perf_counter()
    wl_launches = workload_phase(coord)
    phase("workload", t0)

    t0 = time.perf_counter()
    workload_parity_phase()
    phase("workload-parity", t0)

    t0 = time.perf_counter()
    failover_phase(coord, expected)
    phase("failover", t0)

    t0 = time.perf_counter()
    trace_phase()
    phase("trace", t0)

    t0 = time.perf_counter()
    planner_phase()
    phase("planner", t0)
    print(f"[phase] query-engine phases (workload to planner): "
          f"{time.perf_counter() - t_new:.3f} s", flush=True)

    t0 = time.perf_counter()
    ssd_rec, ssd_err = ssd_phase(dev)
    phase("ssd kernel", t0)

    t0 = time.perf_counter()
    ssd_launches = serve_phase(dev, "mamba2-2.7b",
                               SERVE_F32_PROMPT)["ssd_scan"]
    phase("serve", t0)

    t0 = time.perf_counter()
    prefill_parity(get_config("mamba2-2.7b").replace(
        num_layers=PARITY_LAYERS), PARITY_PROMPT, dev,
        (torch.float32, torch.bfloat16))
    phase("serve parity", t0)

    t0 = time.perf_counter()
    flash_rec, mla_rec, flash_new, flash_err = flash_phase(dev)
    phase("flash kernel", t0)

    t0 = time.perf_counter()
    grad_phase(dev)
    phase("grad", t0)

    t0 = time.perf_counter()
    print(f"[dense] allocated before the dense phases: {release()} bytes",
          flush=True)
    flash_launches = serve_phase(dev, DENSE_ARCH,
                                 DENSE_F32_PROMPT)["flash_gqa"]
    phase("dense serve", t0)

    t0 = time.perf_counter()
    release()
    prefill_parity(get_config(DENSE_ARCH).replace(
        num_layers=DENSE_PARITY_LAYERS), DENSE_PARITY_PROMPT, dev,
        (torch.float32, torch.bfloat16))
    prefill_parity(get_config(SMOLLM_ARCH), DENSE_PARITY_PROMPT, dev,
                   (torch.float32,))
    phase("dense parity", t0)

    t0 = time.perf_counter()
    release()
    dispatch_recs = moe_dispatch_phase(dev)
    share_pack_phase(dev)
    combine_recs = moe_combine_phase(dev)
    phase("moe dispatch", t0)

    t0 = time.perf_counter()
    print(f"[moe] allocated before the MoE serve phase: {release()} bytes",
          flush=True)
    moe_launches = serve_phase(dev, MOE_ARCH, MOE_F32_PROMPT)
    phase("moe serve", t0)

    t0 = time.perf_counter()
    release()
    prefill_parity(get_config(MOE_ARCH).replace(
        num_layers=MOE_PARITY_LAYERS), MOE_PARITY_PROMPT, dev,
        (torch.float32, torch.bfloat16))
    phase("moe parity", t0)

    t_new = time.perf_counter()
    family = {}
    for arch, f32_prompt in ((GRIFFIN_ARCH, GRIFFIN_F32_PROMPT),
                             (WHISPER_ARCH, WHISPER_F32_PROMPT),
                             (LLAMA4_ARCH, None)):
        t0 = time.perf_counter()
        print(f"[{arch}] allocated before its serve phase: {release()} "
              "bytes", flush=True)
        family[arch] = (llama4_serve_phase(dev) if f32_prompt is None
                        else serve_phase(dev, arch, f32_prompt))
        phase(f"{arch} serve", t0)

        t0 = time.perf_counter()
        release()
        prefill_parity(smoke_config(arch), FAMILY_PARITY_PROMPT, dev,
                       (torch.float32, torch.bfloat16))
        if arch == GRIFFIN_ARCH:
            replay_parity(smoke_config(arch), GRIFFIN_REPLAY_PROMPT, dev)
        phase(f"{arch} parity", t0)
    print(f"[phase] serve phases of recurrentgemma, whisper and llama4: "
          f"{time.perf_counter() - t_new:.3f} s", flush=True)
    new_paths = {f"{arch} serve": n for arch, n in family.items()}

    t0 = time.perf_counter()
    print(f"[train parity] allocated before: {release()} bytes", flush=True)
    train_grad_parity(dev)
    phase(f"{SMOLLM_ARCH} train parity", t0)

    t_new = time.perf_counter()
    train = {}
    for arch, layers in TRAIN_CELLS:
        t0 = time.perf_counter()
        print(f"[{arch}] allocated before its train phase: {release()} "
              "bytes", flush=True)
        train[f"train {arch}"] = train_phase(dev, arch, layers)
        phase(f"{arch} train", t0)
    print(f"[phase] train phases: {time.perf_counter() - t_new:.3f} s",
          flush=True)

    t_new = time.perf_counter()
    elastic = {}
    for arch, layers in ELASTIC_CELLS:
        t0 = time.perf_counter()
        print(f"[{arch}] allocated before its elastic phase: {release()} "
              "bytes", flush=True)
        for run, n in elastic_phase(dev, arch, layers).items():
            elastic[f"elastic {arch} {run}"] = n
        phase(f"{arch} elastic", t0)
    print(f"[phase] elastic phases: {time.perf_counter() - t_new:.3f} s",
          flush=True)
    t0 = time.perf_counter()
    dryrun = dryrun_phase(dev, smi)
    phase("dryrun", t0)
    pp_paths = {"query": launches, "workload": wl_launches,
                "moe serve": moe_launches["partition_pack"],
                f"{LLAMA4_ARCH} serve": new_paths[
                    f"{LLAMA4_ARCH} serve"]["partition_pack"],
                f"train {MOE_ARCH}": train[f"train {MOE_ARCH}"][
                    "partition_pack"],
                **{path: n["partition_pack"] for path, n in dryrun.items()
                   if n["partition_pack"]}}
    combine_paths = {"moe serve": moe_launches["moe_combine"],
                     f"{LLAMA4_ARCH} serve": new_paths[
                         f"{LLAMA4_ARCH} serve"]["moe_combine"],
                     f"train {MOE_ARCH}": train[f"train {MOE_ARCH}"][
                         "moe_combine"],
                     **{path: n["moe_combine"] for path, n in dryrun.items()
                        if n["moe_combine"]}}
    ssd_paths = {"serve": ssd_launches,
                 "train mamba2-2.7b": train["train mamba2-2.7b"]["ssd_scan"],
                 **{path: n["ssd_scan"] for path, n in {
                     **elastic, **dryrun}.items() if n["ssd_scan"]}}
    flash_paths = {"dense serve": flash_launches,
                   "moe serve": moe_launches["flash_gqa"],
                   **{path: n["flash_gqa"] for path, n in new_paths.items()},
                   **{path: n["flash_gqa"] for path, n in {
                       **train, **elastic, **dryrun}.items()
                          if n["flash_gqa"]}}

    print(json.dumps({"kernels": [{
        "name": "partition_pack", "route": "cuda",
        "source": "src/repro_torch/kernels/partition_pack/csrc/"
                  "partition_pack.cu",
        "replaces": "src/repro/kernels/partition_pack/partition_pack.py:83",
        "launches": sum(pp_paths.values()), "launches_by_path": pp_paths,
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": main_rec["kernel_ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": "bytes",
        "library_ms": main_rec["library_ms"],
        "moe_dispatch": {r["case"]: {
            key: r[key] for key in ("n_parts", "capacity", "kernel_ms",
                                    "per_group_kernel_ms", "plain_ms",
                                    "library_ms", "bound_ms", "dispatch_ms",
                                    "dispatch_bound_ms", "row_pack_ms")}
            for r in dispatch_recs}}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:65",
        "launches": sum(ssd_paths.values()), "launches_by_path": ssd_paths,
        "max_abs_err": ssd_err,
        "ms": ssd_rec["kernel_ms"], "plain_ms": ssd_rec["plain_ms"],
        "bound_ms": ssd_rec["bound_ms"], "bound_by": ssd_rec["bound_by"],
        "library_ms": None}, {
        "name": "flash_gqa", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_gqa/csrc/flash_gqa.cu",
        "replaces": "src/repro/kernels/flash_gqa/flash_gqa.py:72",
        "launches": sum(flash_paths.values()),
        "launches_by_path": flash_paths,
        "max_abs_err": flash_err,
        "ms": flash_rec["kernel_ms"], "plain_ms": flash_rec["plain_ms"],
        "bound_ms": flash_rec["bound_ms"],
        "bound_by": flash_rec["bound_by"],
        "library_ms": flash_rec["library_ms"],
        "cuda_functions": FK.BODY_KERNELS,
        "body": flash_rec["body"],
        "mla_prefill": {key: mla_rec[key] for key in (
            "case", "body", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_backend", "max_abs_err")},
        **{name: {key: r[key] for key in (
            "case", "body", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_backend", "max_abs_err", "f32")}
           for name, r in flash_new.items()}}, {
        "name": "moe_combine", "route": "cuda",
        "source": "src/repro_torch/kernels/moe_combine/csrc/moe_combine.cu",
        "replaces": None,
        "launches": sum(combine_paths.values()),
        "launches_by_path": combine_paths,
        "max_term_steps_from_plain": max(r["term_steps_from_plain_max"]
                                         for r in combine_recs),
        "ms": combine_recs[-1]["kernel_ms"],
        "plain_ms": combine_recs[-1]["plain_ms"],
        "bound_ms": combine_recs[-1]["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "cells": {r["case"]: {key: r[key] for key in (
            "kept", "kernel_ms", "plain_ms", "bound_ms", "bound_share")}
            for r in combine_recs}}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    if sys.argv[1:2] == ["--mesh-worker"]:
        mesh_worker(sys.argv[2])
        sys.exit(0)
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
