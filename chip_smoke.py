#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold every
hand-written kernel against its plain PyTorch version.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (a line of JSON after each):
 1. card     — CUDA present, card name and power limit, TF32 off.
 2. build    — compile every kernel (one nvcc per source, in parallel,
               with -Xptxas -v); the line carries ptxas's registers, spill
               bytes and warnings per kernel, and the script fails if a
               wgmma kernel spills or ptxas serialised its wgmma (C7518),
               or if an f32 instance is not bin_scores_f32_kernel's (24:
               A, 5, 7 bin-major and 2 transposed).
 3. kernels  — kernel A (bin scores, bin-major) and kernel 2 (its
               transposed layout), both score dtypes, at 1, 7, 64, 100, 130
               and 256 queries (the n64 / n128 / n256 query tiles), kernel A
               also at 65, 128, 129 and 257 (two query tiles), at n_valid =
               1000 (whole tiles past it) and at d = 96 (a half 64-dim
               chunk); kernel 4 (int8 bin scores, both layouts, both score
               dtypes, bit for bit) and kernel 5 (bin maxima only) at 1, 7,
               64, 65, 100, 128, 129, 130, 256 and 257 queries, at n_valid =
               1000 and at d = 192 (kernel 4: a half 128-byte stage) or 96
               (kernel 5); kernel B (flash attention, also
               at S = 1000 and lengths 0, 1, 127, 128, 129, S around its
               128-row tiles), kernel 7 (sketch upper-bound bin maxima:
               ds in {96, 128, 512} (512: Q streamed, not resident), 1, 7,
               256 and 257 queries, ragged n_valid and n_valid = 1000, G in
               {8, 16}) and kernel 6 (MaxSim: ragged K,
               a candidate with every token masked, masked query tokens)
               against their plain versions; a sketch index with ds = d
               certifies every query and returns the exact ids; kernel B
               and plain attention timed at S = 256 and 512 (the flash/plain
               crossover, measured only).
 4. encoder  — BGE-M3 width (24 layers, d=1024), seeded random init, bf16:
               512 query pairs (plain attention) and 256 passages of
               600-1000 words at a 1024 bucket (kernel B); one tokenized
               batch of 32 passages through the model alone, with kernel B
               and with plain attention (device time, no tokenizer); the
               encoder's host phase stats at the 1024 bucket.
 4b. packed  — 4,096 passages of mMARCO-like lengths (20-200 words, a tenth
               300-480) encoded packed (pack=True: rows of 256, the leading
               chunks 512, kernel B on those) and unpacked, and packed with
               every row at 512; packed embeddings within cosine 0.999 and
               TOL_PACKED_ABS of the unpacked ones; passages/s, packing
               efficiency and phase stats; kernel B against its plain version
               at the packed shape (one forward's rows of 512 with their
               segment ids); then `encode-corpus --pack --storage_dtype int8
               --tokens_per_doc 32` through the CLI and `run-mix` over its
               store (the exact int8 top-k).
 5. search   — the vector-mix run over an 8,841,823 x 1024 bf16 index (one
               mMARCO language): alpha in {0, .25, .5, .75, 1} at k=100 and
               alpha=.5 at k=1000, the two-level route (kernel A bin-major);
               RR@10, f32-oracle overlap and the kernel's own stable top-k;
               the fused sweep (fused_alpha_sweep, same 5 alphas at k=100)
               beside it, its ids equal to the unfused runs'; the k=1000 run
               written by the native TREC writer and by the Python one.
 5b. int8   — the phase-5 index quantized on the card (8,841,823 x 1024
               int8 + scales) and the same run over it: the int8 two-level
               route (kernel 4 bin-major); ids equal a stable top-k of the
               plain int8 scores for all 512 queries, RR@10, queries/s.
 5c. rescore — topk_ip(method="bins_rescore") at k=100 and
               topk_ip_rescore_two_level at k=1000 on the bf16 index
               (kernel 5); overlap with the f32 oracle.
 5d. sketch  — the phase-5 index reshaped in place into an anisotropic
               corpus (column i scaled by exp(-0.009 i), rows renormalised;
               queries alike), enable_sketch(sketch_dim=128), the run-mix
               loop with approx=True and approx="guaranteed" (5 alphas at
               k=100, alpha=.5 at k=1000; kernel 7) and exactly; every
               guaranteed query has the exact run's ids; approx=True at k=1,
               alpha=.5, where each query's planted row certifies; certified
               queries have the exact run's ids (swaps only between scores
               within 1e-5: their scores come from the rescore's products),
               calibrate_sketch; the fused sweep exact and guaranteed
               (fused_alpha_sweep_guaranteed, kernel 7), equal ids, and at
               k=1 fast and guaranteed, where planted queries certify: the
               fast sweep's certified rows are the exact sweep's (swaps only
               within ties), the guaranteed ids equal the exact ones.
 5e. adaptive — 8,841,823 x 1024 bf16 clustered rows of its own (256
               centres, row i = normalize(center[a_i] + 0.35/sqrt(d) noise_i),
               the assignments in random order) and 512 queries made alike:
               search(approx="adaptive") at k=100 before reorder_rows() (its
               host seconds and peak resident set), the certified share per
               probe depth before and after, calibrate_adaptive at k=100 and
               1000, adaptive against exact search in turns (q/s), guaranteed
               mode (the adaptive route where calibration measured >= 1.05x),
               both escalation branches (> B/2 on the random order, <= B/2 at
               a bisected probe depth); adaptive ids and values equal exact
               search's everywhere; kernel A on the path.
 6. cli      — `python -m codemix_dense_retrieval_torch run-mix` (run in this
               process) on a BGE-M3-width params.npz checkpoint and a
               131,072-row store: the single-level route (kernel 2, transposed);
               `run-mix --fused --qrels` (ids equal the unfused run's) and
               `run-bilingual-mix --fused --qrels` over that store and a
               parallel second language (a 262,144-row hub: kernel A);
               `run-mix --approx adaptive` (kernel A; the run files equal
               --approx off's byte for byte).
 6b. corpus  — `encode-corpus --storage_dtype int8 --tokens_per_doc 32` on
               2,048 passages of 600-1000 words (cut to the CLI's 512-token
               cap, so plain attention, as in the JAX package) and 512 of a
               second language, then
               `run-mix` over that int8 store (kernel 4 transposed), `run-mix
               --approx guaranteed` (kernel 7; the int8 sketch tier) and
               `run-rerank --k 100 --k_dense 400` (kernel 6), also over both
               languages (the bilingual two-stage), and `run-mix --fused
               --qrels` over the int8 store (kernel 4 in the fused sweep),
               `run-mix --approx adaptive` over it (exact search on an int8
               store) and `run-rerank --approx adaptive` (the same ids);
               the run-mix runs equal the exact int8 top-k; passages/s.
 6c. twostage — a 131,072-row bf16 index and a 131,072 x 32 x 1024 int8
               token store written by TokenShardWriter, 512 queries of 32
               tokens with one planted document each:
               run_two_stage_search(k=100, k_dense=400), card-resident
               (kernel 6); ids equal a stable top-100 of the plain MaxSim
               over the same candidates (swaps only within 1e-4), RR@10,
               the memmap path gives the same ids, and so does the dense
               stage through the adaptive tier (kernel A).
 7. kernels line — per kernel, at the main path's shape: the check against
               its plain version again, max error, time (mean, fastest and
               slowest of 5 timed windows), its bound, the plain version's and
               one PyTorch call's time (a yardstick the port never calls).
 8. hub      — the bilingual hub at the paper's size: the phase-5 rows
               (language 1) and a parallel language 2 made from them on the
               card (row i: normalize(row_i + 0.3 u_i), u_i a random unit
               vector, the same docid), joined by DenseFlatIndex.merged
               (17,683,646 x 1024 bf16, 36.2 GB on the card), searched with
               the phase-4 query pairs, asking for the CLI's 1024-query block
               (kept whole: phase 1 writes bin maxima alone; fit_query_block);
               run_bilingual_vector_mix (5 alphas, k=500, raw run + host
               collapse) and run_bilingual_vector_mix_fused (2k raw depth,
               on-device collapse and metrics, planted qrels); kernel A
               against its plain version on one block at the hub's shape
               (its score store passes 2^32 elements); per query the
               unfused collapsed run is a prefix of the fused one (order free
               only among equal printed scores); the fused ids of 64 queries
               equal a stable collapsed top-500 of kernel A's own scores; the
               device metrics x100 equal `evaluate` on the fused runs within
               1e-4, RR@10 = 100 at alpha = .5; kernel A's time per block.
 9. serve    — SearchService + make_server in this process on 127.0.0.1 (an
               ephemeral port), the phase-4 encoder behind a recorder of the
               query embeddings, http.client clients, every request with its
               own timeout. 9a: the phase-5 rows uploaded anew (8,841,823 x
               1024 bf16, kernel A), warmup, provoked 400s, mixed traffic (512
               single queries from 64 client threads and 8 requests of 64 at
               k in {10, 100, 1000}: q/s, p50 / p99 latency, mean coalesced
               batch), served ids and scores equal to one direct search of the
               recorded embeddings; /add of 256 query texts as documents (in
               the capacity; the docid table's seconds), /add of 1,024 passages
               of 600-1000 words (kernel B; grows the index: its seconds and
               the card peak), each added document at rank 1, /remove of all,
               then the replies of before the adds. 9b: the phase-6 store
               (131,072 rows, kernel 2) served exact, guaranteed (kernel 7,
               the exact ids up to ties) and fast at k = 1 (certified rows
               equal exact) around an /add that grows it and a /remove; the
               phase-6b int8 store with its token store served two-stage
               (kernels 4 and 6) through /add and a /remove with a swap chain,
               equal to a direct TwoStageSearcher.search; the int8 store
               served exact through /add and /remove (the exact int8 top-k),
               /save into a snapshot root and /reload (the same ids).
               Then each kernel's launches on all the paths.
10. dtypes   — store dtypes and encoder families. 10a: Qwen3-Embedding-0.6B
               at its published widths (28 layers, d=1024, 16 query heads
               over 8 KV heads of 128), seeded random init on the card,
               written as an HF-format dir (config.json + pytorch_model.bin)
               and loaded by registry.load_encoder (bf16, kernel B causal at
               every length): 512 queries, the same through a plain-attention
               copy of the model (use_flash=False, within TOL_PACKED_ABS),
               the 2,048 phase-6b passages at the 1024 bucket and the same
               packed, the 512 query texts packed into rows of 256 (many
               segments a row, per-segment RoPE) against their unpacked
               encode (within TOL_PACKED_ABS), unit norms; kernel B's causal
               GQA dh=128 instance against its plain version at S = 16-512
               (ragged lengths; packed segment ids) and at 1024, timed there
               beside SDPA, and timed at every bucket (S = 16-1024, full and
               ragged lengths) beside SDPA and its bound (the
               qwen3_kernel_b_buckets line). 10b: `encode-corpus --storage_dtype
               float32|float16 --token_dtype <same> --tokens_per_doc 32` with
               that checkpoint over the phase-6b corpus, `run-mix` exact,
               `--approx guaranteed` (the exact ids; exact against a plain
               top-k of the store up to ties) and `--fused --qrels` (the
               exact ids), the fused bilingual hub over the store and a
               parallel second language of its dtype (against a plain
               per-document max over both), and `run-rerank` over each
               (kernels 2 and 6 in f32 and f16). 10c: the f16 and f32
               instances of A, 2, 5 and the f32 one of 7 at phase 3's tile
               edges (1-257 queries, ragged n_valid, G 8 and 16, d = 96),
               and kernel 2 f32 at B = 1, 63, 64, 65, 128, 129, 255, 256 x
               N = 12,816, 20,000, 131,072 x d = 32, 96, 1024 x G x score
               dtype (n_valid = N - 77);
               then 8,841,823 x 1024 rows
               made in f32 on the card (full mantissas, phase 5's planted
               rows), an f32 index: exact search at k=100 and 1000 (512
               queries) equal to the plain f32 top-k up to ties, the fused
               alpha sweep (the exact ids at alpha = .5) and the adaptive
               tier at k = 1 and 100 (the exact results), the rescore
               search (kernel 5), the sketch tier guaranteed (exact ids) and
               the f32 sketch tier of ops.sketch (kernel 7 over f32);
               kernels A, 5, 2 and 7 in f32 against their plain versions
               within TOL_F32 and timed (2 also at hubness_stats' B = 256,
               N = 20,000); then the same rows in f16 (search,
               fused sweep, adaptive tier, rescore; kernels A, 5, 2 in f16,
               within 1e-4); kernel 6 over f16 and f32 doc
               tokens at the two-stage shape. 10d: GTE-multilingual-base and
               jina-embeddings-v3 at full width, random init: 256 queries
               and 256 passages each, jina-v3's query and passage embeddings
               of the same texts differ (task adapters), GTE refuses
               pack=True.
11. weight quantization and the tools (phase_11). 11a: BGE-M3 at full
               width from one seeded f32 init, as a bf16 copy and as
               TextEncoder(weight_quant="int8" / "nf4") (host quantization
               seconds, resident bytes, card peak, queries/s and passages/s
               at the 1024 bucket, kernel B); each quantized encoder equals a
               bf16 copy of its own dequantized weights (min cos 0.999, max
               abs TOL_PACKED_ABS); against the bf16 copy int8 keeps the JAX
               suite's cosine bound at full width, and both modes keep theirs
               (MIN_COS_WQ) at the suite's depth of 2 layers (NF4 at 24
               random layers is measured, not bounded). 11b: `convert
               --weight_quant nf4` of phase 10a's Qwen3 HF dir, `encode-corpus`
               from the converted dir (rows equal to an in-memory
               weight_quant="nf4" encoder's, bit for bit) and `run-mix` over
               its store (kernels 2 and B causal). 11c: `tune` into a store
               under the work dir (the two-level cover at 262,144 x 1024, k =
               100 and 1000; the flash crossover at S = 128-1024, dh = 64),
               Qwen3's causal dh = 128 crossover measured; the pickers and the
               flash dispatch read the store, and the tuned two-level search
               gives the default one's ids. 11d: `profile` over a 1,048,576 x
               1024 bf16 index at k = 100: its Chrome trace names kernel A.
12. the host tools (phase_12). 12a: `analyze`'s card part: 512 EN, ZH
               and CM (each pair's words swapped at a cut) query texts
               through phase 6's checkpoint, the host metrics of
               analyze_triplets (line metrics, linear reconstruction,
               anisotropy, outliers; r, delta and alpha held against a
               float64 recomputation on the card; the probe and the
               projections need scikit-learn and are not called), then
               hubness_stats over 20,940 seeded f32 unit rows x 1024 (3 x
               mMARCO dev) sampled to max_vectors = 20,000, k = 10 (kernel 2,
               f32 instance): its neighbour ids equal the plain route's
               (topk_ip(method="full"), f32 with TF32 off) except on rows
               whose plain 10th and 11th neighbour scores lie within TOL_F32,
               and its in-degree stats within those rows' reach; the wall,
               the share inside kernel 2's wrapper (CUDA events) and the host
               loop's seconds. 12b: two parallel 131,072-row bf16 stores (en,
               zh; one planted row for each of 256 query pairs, the alpha =
               .5 mix of its embeddings) and their qrels; `make-plan en-zh-repro` (3
               vector-mix jobs: EN docs, ZH docs and the 262,144-row hub, on
               kernels 2 and A) with the checkpoint, `sweep --slots 2` (each
               job a `python -m codemix_dense_retrieval_torch` process, then
               its evaluate steps), RR@10 = 100 at alpha = .5 in every job,
               the EN job's argv again in this process (kernel 2 counted; its
               runs byte-equal to the swept ones), `collect` plain and
               `--reference_format` (3 jobs x 7 alphas), `paper-values
               --n_boot 200`.
13. multi-device on the one card (phase_13). 13a: 8,841,823 x 1024 bf16
               rows by phase 5's recipe (Rows13: a seeded generator per
               262,144 rows) on a one-shard and a 4-shard mesh of cuda:0
               (2,210,816 rows a shard, kernel 5 and cover_rescore per
               shard): 512 query mixes
               at k = 100 and 1000, ids and values equal; the 256-query
               block's wall on 1 and 4 shards and the merge's ms; the
               guaranteed tier (kernel 7) equal to exact; the int8 store
               (kernel 4) on both meshes, equal; one mutation round per mesh
               (add 4,096: both grow; remove 4,096; rebalance: rows move
               between the shards), the searches by docid equal up to the
               order inside runs of equal scores; phase 6's 131,072-row
               store on 4 shards (the transposed route, kernel 2), equal.
               13b: `chip_smoke.py --phase13-worker` processes: 2 on gloo
               with 2 shards each (NCCL refuses two ranks on one card), each
               making only its own rows through shard_rows_multihost, and 1
               on NCCL (world size 1, 4 shards; its all-gather and
               all-reduce run on the (B, k) payload): every result equals
               13a's 4-shard one; each rank's wall and gathered bytes. 13c:
               phase 6's BGE-M3 through TextEncoder(mesh=2 shards of
               cuda:0) on the 256 passages at the 1024 bucket: kernel B per
               replica chunk, least cosine MIN_COS_MESH against one device.
               13d: Qwen3-0.6B (phase 10a's dir) TP over a tp = 2 mesh of
               cuda:0, 8 / 4 heads per half, 32 x 512 tokens, bf16 and int8:
               kernel B causal on both halves; bf16 held against the f32
               forward beside the replicated one (TP_ERR_RATIO), int8 against
               the replicated int8 forward (MIN_COS_TP_INT8).
14. cover    — cover_rescore (phase_cover_rescore), bf16 and f16, 3 seeds,
               8,842,240 x 1024 unit rows made on the card with ties planted
               (16 queries' top rows copied over 20 bins; copies straddling
               n_valid = 8,841,823, pad rows included): at 256, 100 and 48
               queries (kernel A's n128 and n64 tiles) kernel 5's bin maxima
               equal kernel A's and the rescored covered bins (k = 100 and
               1000 bins) equal kernel A's stored scores, as bits; over 1024
               queries at k = 10, 100 and 1000 the route without the store
               (topk_ip_bins_two_level) returns the stored route's values and
               ids; its time at B = 256, k = 100 beside its bound and plain
               version, and one 256-query chunk by either route.
               `python3 chip_smoke.py --cover-rescore` builds the bf16 and
               f16 bin sources and cover_rescore.cu and runs this phase alone.
15. select   — super_select (phase_super_select): the two-level cover's
               super level against its plain version on the card (amax,
               whole-row stable sort, id sort), values and ids as bits, 3
               seeds of f32 bin maxima made on the card with ties planted
               (equal supers across the k-th, a row of equal maxima, +0.0 /
               -0.0 maxima and mixed zero bins, NaNs, NEG_INF past n_valid,
               rows whose valid supers are fewer than k, top supers packed
               into few groups): B = 256 at nb = 1,105,280 (8,842,240 rows
               at G = 8), M = 8, 4, 16, and B = 1, 100, 257, 64, 7, k_bins =
               10, 100, 1000 and 4095, ns <= k_bins; past 4,096 supers kept
               (the sort in device memory: k_bins 4096 and 20,000, ns =
               6,000 and 5,000 <= k_bins); over 1024 queries of
               phase 14's bf16 index at k = 10, 100 and 1000 the exact route
               returns the plain super level's values and ids; the kernel's
               time at the main shape beside its bound, the plain version and
               amax + torch.topk. `python3 chip_smoke.py --super-select`
               builds super_select.cu (its ptxas gate), the bf16 bin source
               and cover_rescore.cu and runs this phase alone.
16. kda      — Kimi Linear's kernels (phase_kda), run alone by `python3
               chip_smoke.py --kda` and not part of the full run (which
               already takes ~1,190 s of its 1,200): kda_chunk against its
               plain version (the same chunk form in f32 torch) at 256 rows
               x 512 (lengths 1-512) and packed rows of 32 x 512, 32 heads
               of 128, per-step log decays 0 to -20 (head 0 at -20), beta
               0 and 1 planted, 2 seeds; on the operands of the cell's 256
               x 512 forward (and 64 packed rows) kda_ops (short_conv as v,
               k and q, decay_gate, gated_rms_norm) against theirs, each
               bf16 element within one rounding of the plain one (g, beta
               1e-4 relative); moe_rows (gather bit for bit, SiLU-mul,
               combine) on a MoE layer of the cell's 256-passage forward
               (~20k tokens, 8 of 256 experts each, 32 held: ~164k slots,
               ~20k live, the rest NaN and never read); the seven kernels'
               times beside their bounds and plain versions (the kernel
               table's rows); encode_corpus through TextEncoder over a
               4-layer Kimi Linear at the published widths (3 KDA, 1 NoPE
               MLA, 8 of 64 experts held), unpacked and packed, launching
               each of the seven. The ptxas gate covers kda_chunk.cu,
               kda_ops.cu and moe_rows.cu (no spill).
Launch counts are set to 0 just before each path (phases 4, 4b, 5, 5b, 5c,
5d, 5e, 6, 6b, 6c, 8, each service of 9, each path of 10 and their fused
runs, each encoder and command of 11, 12a's hubness_stats and 12b's
in-process rerun, 13a's searches and mutation, 13c's encode, 13d's TP
forwards) and read just after it; comparison and timing launches happen outside those windows (in
phase 9 the direct searches run while the service is idle, their launches
taken back out of the count). Phases 14 and 15 keep their bit checks'
counts under keys starting "bits.", which the kernels line's totals (and
its "never launched on the main path" check) leave out. Every TREC run of the paths is
written by the native writer (csrc/fastio.cpp, built in phase 2).
Before the kernels line, a phase_walls line gives the second at which each
phase began. The last line is the device JSON. Any failed check raises
(exit code != 0).
"""

from __future__ import annotations

import contextlib
import gc
import http.client
import io
import json
import math
import os
import pathlib
import runpy
import shutil
import subprocess
import sys
import threading
import time

REPO = pathlib.Path(__file__).resolve().parent
SEED = 20261016
N_ROWS = 8_841_823          # one mMARCO language
SMALL_ROWS = 131_072        # the CLI phase's store
N_CORPUS = 2048             # passages of the encode-corpus phase
N_CORPUS_YY = 512           # passages of its second language
DIM = 1024
N_QUERIES = 512
N_PASSAGES = 256
ALPHAS = (0.0, 0.25, 0.5, 0.75, 1.0)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOPS = 989e12         # H100 SXM dense bf16 (and f16) tensor-core peak
TF32_FLOPS = 494.7e12       # H100 SXM dense tf32 tensor-core peak; f32-faithful
                            # work counts three tf32 passes (hi.hi + hi.lo + lo.hi)
INT8_OPS = 1979e12          # H100 SXM dense int8 tensor-core peak
# kernel 7 vs its plain version: the same exact bf16 products, summed in f32
# in another order (|ub| < 1.5 here, so a few f32 ulps)
TOL_BINUB = 1e-6
# the f32 instances (3xTF32) vs their plain f32 versions on unit rows at
# d = 1024 with full f32 mantissas: summation order plus the tf32 split's
# ~3 * 2^-22 of sum |x_i y_i|. One tf32 pass or bf16 operands would miss it
# by ~1e-3
TOL_F32 = 2e-6
N_QWEN_QUERIES = 512        # phase 10a
# kernel 6 vs its plain version: |kernel - plain| <= TOL_MAXSIM + TOL_MAXSIM_REL
# * |plain|. The f32 query split into bf16 hi + lo keeps it to ~2^-16
# relative, the tensor cores' f32 accumulation does not round to nearest,
# and 32 maxima are summed in another order; scores reach ~30 when the
# query's tokens all have near twins
TOL_MAXSIM = 2e-5
TOL_MAXSIM_REL = 3e-6
TIE_TOL = 1e-5              # two runs' ids may swap only between scores this close
TIE_TOL_MAXSIM = 1e-4       # the same for MaxSim scores (sums of 32 maxima)
TQ = TD = 32                # two-stage query and doc tokens
# the kernels' function names in csrc/ (ptxas reports template instances
# under mangled names that contain them); the wgmma ones may not spill
KERNEL_NAMES = ("bin_scores_bm_kernel", "bin_scores_t_kernel", "bin_scores_f32_kernel", "tf32_split_kernel",
                "flash_fwd_wgmma", "flash_fwd_f32", "maxsim_kernel", "cover_rescore_kernel", "super_max_kernel",
                "super_select_kernel", "super_select_wide_kernel", "kda_chunk_kernel", "kda_conv_kernel",
                "kda_gate_kernel", "kda_out_kernel", "moe_gather_kernel", "moe_act_kernel", "moe_combine_kernel")
WGMMA_KERNELS = {"bin_scores_bm_kernel", "bin_scores_t_kernel", "bin_scores_f32_kernel", "flash_fwd_wgmma",
                 "cover_rescore_kernel"}
# kernels that may not spill besides the wgmma ones
NO_SPILL_KERNELS = WGMMA_KERNELS | {"super_max_kernel", "super_select_kernel", "super_select_wide_kernel",
                                    "kda_chunk_kernel", "kda_conv_kernel", "kda_gate_kernel", "kda_out_kernel",
                                    "moe_gather_kernel", "moe_act_kernel", "moe_combine_kernel"}
K_DENSE = 400               # two-stage dense recall depth
N_CENTERS = 256             # topical clusters of the adaptive phase's rows
N_PACKED = 4096             # passages of the packed-encode phase
PACK_BATCH = 256            # its passages per forward (packed: 32 rows)
# packed vs unpacked BGE-M3 and Qwen3 embeddings (bf16 models): the same
# tokens and positions, summed in another order and attended by another
# kernel; also Qwen3's kernel-B path against its plain-attention copy
TOL_PACKED_ABS = 1e-2
# phase 11: pooled cosine of the int8 / NF4 encoders against their bf16 copy,
# the JAX suite's bounds (tests/test_weight_quant.py)
MIN_COS_WQ = {"int8": 0.995, "nf4": 0.95}


def say(tag: str, **fields) -> None:
    print(f"[{tag}] " + json.dumps(fields, default=float), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` launches between CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps: int, windows: int = 5) -> dict:
    """A kernel's time: ``ms`` the mean over ``windows`` separately timed
    windows of ``reps`` launches each, ``ms_min`` / ``ms_max`` the fastest
    and slowest window's mean."""
    per = [cuda_ms(fn, reps) for _ in range(windows)]
    return {"ms": sum(per) / len(per), "ms_min": min(per), "ms_max": max(per)}


def bound(nbytes: float, ops: float, peak: float = BF16_FLOPS):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the operations over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run_cli(argv) -> None:
    """``python -m codemix_dense_retrieval_torch <argv[1:]>`` in this process."""
    saved_argv = sys.argv
    try:
        sys.argv = argv
        runpy.run_module("codemix_dense_retrieval_torch", run_name="__main__", alter_sys=True)
    finally:
        sys.argv = saved_argv


def run_cli_json(argv):
    """run_cli, and the JSON the command printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_cli(argv)
    return json.loads(buf.getvalue())


def phase_11(dev, work, smi, path_counts, texts_a, passages, buckets, corpus_tsv, qdir, en_tsv, zh_tsv) -> None:
    """Phase 11: encoder weight quantization and the tuning / profiling
    tools (see the module docstring). Adds its paths' launch counts to
    ``path_counts``; raises on any failed check."""
    import numpy as np
    import torch

    from codemix_dense_retrieval_torch.io.shards import ShardStore, storage_to_tensor
    from codemix_dense_retrieval_torch.models import encoder as encoder_mod
    from codemix_dense_retrieval_torch.models.encoder import TextEncoder, quantize_state_dict
    from codemix_dense_retrieval_torch.models.registry import load_encoder
    from codemix_dense_retrieval_torch.models.xlmr import XLMRConfig, XLMREncoder, init_random_
    from codemix_dense_retrieval_torch.ops import kernels, topk
    from codemix_dense_retrieval_torch.ops.weight_quant import QuantLinear, quantized_nbytes
    from codemix_dense_retrieval_torch.utils import autotune

    t11 = time.perf_counter()

    # 11a. BGE-M3 at full width: one seeded f32 random init (on the card,
    # then to the host), built as a bf16 copy and as int8 / NF4 encoders
    # (TextEncoder(weight_quant=...) quantizes those f32 weights on the
    # host), and as a bf16 copy of each mode's dequantized weights, which
    # the quantized encoder must reproduce (its gap to the bf16 copy is then
    # the quantization's own); the JAX suite's cosine bounds hold at full
    # width for int8 and, for both modes, at the suite's depth of 2 layers
    def init_f32(cfg_):
        with torch.device("meta"):
            m = XLMREncoder(cfg_)
        m = m.to_empty(device=dev)
        init_random_(m, torch.Generator(device=dev).manual_seed(SEED + 20))
        sd_ = {k: v.cpu() for k, v in m.state_dict().items()}
        del m
        torch.cuda.empty_cache()
        return sd_

    def encode(enc_, q_texts, p_texts):
        enc_.encode_queries(q_texts[:8])
        enc_.encode_documents(p_texts[:2], max_length=1024)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qv_ = enc_.encode_queries(q_texts, batch_size=128)
        q_s_ = time.perf_counter() - t0
        t0 = time.perf_counter()
        pv_ = enc_.encode_documents(p_texts, batch_size=32, max_length=1024)
        return qv_, pv_, q_s_, time.perf_counter() - t0

    def agree(a, b):
        return (float(min((a[0] * b[0]).sum(axis=1).min(), (a[1] * b[1]).sum(axis=1).min())),
                float(max(np.abs(a[0] - b[0]).max(), np.abs(a[1] - b[1]).max())))

    # the host seconds of the encoder's own quantize_state_dict call
    quant_s = []

    def timed_quantize(sd_, mode_):
        t0_ = time.perf_counter()
        out_ = quantize_state_dict(sd_, mode_)
        quant_s.append(time.perf_counter() - t0_)
        return out_

    encoder_mod.quantize_state_dict = timed_quantize
    sd32 = init_f32(XLMRConfig.bge_m3())
    bcfg = XLMRConfig.bge_m3(dtype=torch.bfloat16)
    qtexts = texts_a[:N_QUERIES]
    wq, ref = {}, {}
    for mode in ("bf16", "int8", "nf4"):
        quant_s.clear()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        enc = TextEncoder("BAAI/bge-m3", bcfg, sd32, weight_quant=None if mode == "bf16" else mode,
                          length_buckets=buckets)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        resident = quantized_nbytes({**dict(enc.model.named_parameters()), **dict(enc.model.named_buffers())})
        qlayers = [mod for mod in enc.model.modules() if isinstance(mod, QuantLinear)]
        if mode != "bf16":
            check(len(qlayers) == 6 * bcfg.num_layers and enc.weight_quant == mode, f"{mode}: quantized layers")
            check(all(mod.weight.scale.dtype == torch.float32 and mod.codes.device.type == "cuda"
                      for mod in qlayers), f"{mode}: scales f32, codes on the card")
            check(len(quant_s) == 1, f"{mode}: the encoder did not quantize once")
            # the weights the quantized encoder sees, dequantized in f32
            deq = {f"{n}.weight": mod.weight.dequantize(torch.float32).T.contiguous().cpu()
                   for n, mod in enc.model.named_modules() if isinstance(mod, QuantLinear)}
        kernels.reset_launch_counts()
        qv, pv, q_s, p_s = encode(enc, qtexts, passages)
        path_counts[f"wq_{mode}"] = dict(kernels.LAUNCHES)
        check(path_counts[f"wq_{mode}"]["flash_attention"] > 0, f"{mode} passages did not launch kernel B")
        for name_, x, rows in (("queries", qv, N_QUERIES), ("passages", pv, len(passages))):
            check(x.shape == (rows, DIM) and bool(np.isfinite(x).all())
                  and bool(np.allclose(np.linalg.norm(x, axis=1), 1.0, atol=2e-2)), f"{mode} {name_} embeddings")
        peak = torch.cuda.max_memory_allocated() - base
        del enc
        torch.cuda.empty_cache()
        row = dict(resident_bytes=resident, build_s=round(build_s, 2), queries_per_s=round(N_QUERIES / q_s, 1),
                   passages_per_s_1024=round(len(passages) / p_s, 1), card_peak_gb=round(peak / 1e9, 3),
                   kernel_b_launches=path_counts[f"wq_{mode}"]["flash_attention"])
        if mode == "bf16":
            ref = {"emb": (qv, pv), "resident": resident, "pps": len(passages) / p_s, "qps": N_QUERIES / q_s}
        else:
            cos, gap = agree((qv, pv), ref["emb"])
            # those weights held in bf16 by an unquantized encoder
            enc = TextEncoder("BAAI/bge-m3", bcfg, {**sd32, **deq}, length_buckets=buckets)
            d_cos, d_gap = agree((qv, pv), encode(enc, qtexts, passages)[:2])
            del enc, deq
            torch.cuda.empty_cache()
            check(d_cos >= 0.999 and d_gap <= TOL_PACKED_ABS,
                  f"{mode} vs its dequantized bf16 copy: min cos {d_cos}, max abs {d_gap}")
            if mode == "int8":
                check(cos >= MIN_COS_WQ[mode], f"{mode} vs bf16: min cos {cos} (limit {MIN_COS_WQ[mode]})")
            row.update(quantize_host_s=round(quant_s[0], 2), vs_bf16_bytes=resident / ref["resident"],
                       vs_bf16={"min_cos": cos, "max_abs": gap},
                       vs_dequantized_bf16_copy={"min_cos": d_cos, "max_abs": d_gap},
                       passages_per_s_vs_bf16=len(passages) / p_s / ref["pps"],
                       queries_per_s_vs_bf16=N_QUERIES / q_s / ref["qps"])
        wq[mode] = row
    encoder_mod.quantize_state_dict = quantize_state_dict
    del sd32
    # the JAX suite's depth (2 layers) at BGE-M3's widths
    sd2 = init_f32(XLMRConfig.bge_m3(num_layers=2))
    emb2 = {}
    for mode in ("bf16", "int8", "nf4"):
        enc = TextEncoder("BAAI/bge-m3", XLMRConfig.bge_m3(num_layers=2, dtype=torch.bfloat16), sd2,
                          weight_quant=None if mode == "bf16" else mode, length_buckets=buckets)
        emb2[mode] = encode(enc, qtexts, passages)[:2]
        del enc
        if mode != "bf16":
            wq[mode]["two_layers_vs_bf16"] = dict(zip(("min_cos", "max_abs"), agree(emb2[mode], emb2["bf16"])))
            check(wq[mode]["two_layers_vs_bf16"]["min_cos"] >= MIN_COS_WQ[mode],
                  f"2-layer {mode} vs bf16: {wq[mode]['two_layers_vs_bf16']} (limit {MIN_COS_WQ[mode]})")
    del sd2, emb2
    torch.cuda.empty_cache()
    say("weight_quant", smi=smi, config="BGE-M3 (24L, d=1024, FFN 4096, vocab 250002) seeded f32 init, bf16 compute",
        min_cos_limits=MIN_COS_WQ, **wq)

    # 11b. the pre-quantized checkpoint path on phase 10's Qwen3-0.6B HF dir:
    # convert --weight_quant nf4, encode-corpus from it, run-mix over its
    # store; its rows equal an in-memory weight_quant="nf4" encoder's
    qwen = "Qwen/Qwen3-Embedding-0.6B"
    cdir = work / "qwen3_nf4"
    t0 = time.perf_counter()
    run_cli(["codemix_dense_retrieval_torch", "convert", "--encoder", qwen, "--src", str(qdir), "--out", str(cdir),
             "--weight_quant", "nf4"])
    convert_s = time.perf_counter() - t0
    root = work / "corpus_nf4"
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run_cli(["codemix_dense_retrieval_torch", "encode-corpus", "--encoder", qwen, "--checkpoint", str(cdir),
             "--corpus_tsv", f"xx={corpus_tsv}", "--out", str(root), "--batch", "4096", "--enc_batch", "32",
             "--seed", str(SEED)])
    corpus_s = time.perf_counter() - t0
    path_counts["wq_corpus_cli"] = dict(kernels.LAUNCHES)
    check(path_counts["wq_corpus_cli"]["flash_attention_causal"] > 0, "the NF4 encode-corpus did not launch kernel B")
    store = ShardStore.open(root / "xx")
    rows = storage_to_tensor(np.asarray(store.vectors), store.manifest.dtype).float().numpy()
    texts = [line.split("\t", 1)[1] for line in corpus_tsv.read_text().splitlines()]
    mem = load_encoder(qwen, str(qdir), weight_quant="nf4")
    check(mem.weight_quant == "nf4" and type(mem.model).__name__ == "Qwen3Encoder", "in-memory NF4 Qwen3")
    want = mem.encode_documents(texts, batch_size=32, readback_dtype=torch.bfloat16)
    del mem
    torch.cuda.empty_cache()
    check(store.count == len(texts) and rows.shape == want.shape and np.array_equal(rows, want),
          f"the converted NF4 checkpoint's rows differ from the in-memory NF4 encoder's "
          f"(max abs {float(np.abs(rows - want).max()) if rows.shape == want.shape else 'shape'})")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run_cli(["codemix_dense_retrieval_torch", "run-mix", "--encoder", qwen, "--checkpoint", str(cdir),
             "--index", str(root / "xx"), "--query_tsv", f"en={en_tsv}", f"zh={zh_tsv}",
             "--outdir", str(root / "runs"), "--k", "100", "--qblock", "256", "--cm_alphas", "0.5"])
    mix_s = time.perf_counter() - t0
    path_counts["wq_run_mix"] = dict(kernels.LAUNCHES)
    check(path_counts["wq_run_mix"]["bin_scores_transposed"] > 0, "run-mix over the NF4 store did not launch kernel 2")
    check(path_counts["wq_run_mix"]["flash_attention_causal"] > 0, "run-mix's NF4 query encode did not launch kernel B")
    n_lines = len((root / "runs" / "cm-alpha-0.5.trec").read_text().splitlines())
    check(n_lines == N_QUERIES * min(100, len(texts)), f"run-mix over the NF4 store wrote {n_lines} lines")
    say("weight_quant_checkpoint", smi=smi, model="Qwen3-Embedding-0.6B (phase 10a's HF dir, bf16 weights)",
        params_npz_bytes=(cdir / "params.npz").stat().st_size,
        hf_bin_bytes=(qdir / "pytorch_model.bin").stat().st_size, convert_s=round(convert_s, 2),
        encode_corpus_s=round(corpus_s, 2), passages=len(texts), rows_equal_in_memory_nf4=True,
        run_mix_s=round(mix_s, 2),
        launches={k: path_counts[k] for k in ("wq_corpus_cli", "wq_run_mix")})

    # 11c. tune into a temporary store (never the user's cache): the
    # two-level cover at 262,144 x 1024 for k = 100 and 1000 over the full
    # grid (G 8 / 16, M 4 / 8 / 16, tile_b 256 / 512; 1024 exceeds the
    # 512-query batch), BGE-M3's flash crossover (dh = 64) stored, Qwen3's
    # (16 / 8 heads of 128, causal) measured; then the dispatch reads the
    # store and the tuned two-level search returns the default one's ids
    saved_env = os.environ.get("CDR_TUNE_FILE")
    os.environ["CDR_TUNE_FILE"] = str(work / "tuned.json")
    autotune.invalidate_cache()
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        tuned = run_cli_json(["codemix_dense_retrieval_torch", "tune", "--rows", "262144", "--dim", str(DIM),
                              "--batch", "512", "--ks", "100", "1000", "--iters", "3"])
        tune_s = time.perf_counter() - t0
        path_counts["tune"] = dict(kernels.LAUNCHES)
        check(path_counts["tune"]["binmax_only"] > 0 and path_counts["tune"]["cover_rescore"] > 0
              and path_counts["tune"]["super_select"] > 0,
              "the tune sweep did not launch kernel 5, cover_rescore and super_select")
        check(tuned["tune_file"] == str(work / "tuned.json"), "tune wrote another store")
        t0 = time.perf_counter()
        qwen_flash = autotune.autotune_flash(heads=16, kv_heads=8, head_dim=128, causal=True)
        qwen_flash_s = time.perf_counter() - t0
        for k_ in (100, 1000):
            check(topk._auto_bin_size_two_level(k_) == tuned[f"topk.bin_size.k{k_}"]
                  and topk._auto_super_size(k_) == tuned[f"topk.super_size.k{k_}"]
                  and topk._tile_b(None, k_, two_level=True) == tuned[f"topk.tile_b.k{k_}"], f"the pickers ignore the store at k={k_}")
        check(autotune.get_tuned("flash.min_seq") == tuned["flash.min_seq"], "the flash dispatch ignores the store")
        gen = torch.Generator(device=dev).manual_seed(SEED + 21)
        docs = torch.randn(262_144, DIM, device=dev, generator=gen)
        docs = (docs / docs.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        q = torch.randn(N_QUERIES, DIM, device=dev, generator=gen)
        q = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        for k_ in (100, 1000):
            v_t, i_t = topk.topk_ip_bins_two_level(q, docs, k_)
            v_d, i_d = topk.topk_ip_bins_two_level(q, docs, k_, bin_size=8, super_size=8, tile_b=512)
            check(torch.equal(i_t, i_d), f"tuned two-level ids differ from the default at k={k_}")
            check(float((v_t - v_d).abs().max()) <= 1e-6, f"tuned two-level scores differ from the default at k={k_}")
        del docs, q, v_t, i_t, v_d, i_d
    finally:
        if saved_env is None:
            os.environ.pop("CDR_TUNE_FILE", None)
        else:
            os.environ["CDR_TUNE_FILE"] = saved_env
        autotune.invalidate_cache()
    torch.cuda.empty_cache()
    say("tune", smi=smi, seconds=round(tune_s, 2), grid="full (no cut): G 8/16 x M 4/8/16 x tile_b 256/512",
        tuned=tuned, qwen3_causal_dh128=qwen_flash, qwen3_seconds=round(qwen_flash_s, 2),
        tuned_ids_equal_default=True, launches=path_counts["tune"])

    # 11d. profile: a 1,048,576-row bf16 index at k = 100 (two-level route,
    # kernel A); the Chrome trace names kernel A's CUDA symbol
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    prof = run_cli_json(["codemix_dense_retrieval_torch", "profile", "--docs", "1048576", "--dim", str(DIM),
                         "--queries", "1024", "--k", "100", "--iters", "5", "--trace_dir", str(work / "prof")])
    prof_s = time.perf_counter() - t0
    path_counts["profile"] = dict(kernels.LAUNCHES)
    check(path_counts["profile"]["binmax_only"] > 0 and path_counts["profile"]["cover_rescore"] > 0
          and path_counts["profile"]["super_select"] > 0,
          "profile's search did not launch kernel 5, cover_rescore and super_select")
    trace = json.loads((work / "prof" / "search" / "trace.json").read_text())
    names = [ev.get("name", "") for ev in trace["traceEvents"] if ev.get("cat") == "kernel"]
    kernel_a = sorted({n for n in names if "bin_scores_bm_kernel" in n})
    check(bool(kernel_a), f"the profile trace names no kernel A ({len(names)} kernel events)")
    say("profile", smi=smi, **prof, seconds=round(prof_s, 2), kernel_events=len(names),
        kernel_a_events=sum("bin_scores_bm_kernel" in n for n in names), kernel_a_symbol=kernel_a[0][:160] if kernel_a else None,
        launches=path_counts["profile"])
    say("phase11", seconds=round(time.perf_counter() - t11, 2))


class _TimedPopen(subprocess.Popen):
    """A Popen that notes when it started and when it exited: a thread
    waits on the child with WNOWAIT, which leaves it for the scheduler to
    reap (the scheduler runs a finished job's evaluate steps before it
    polls the others, so its own poll would add them to the next job's
    time). Phase 12's seconds per swept job."""

    runs: list = []

    def __init__(self, args, *rest, **kw):
        super().__init__(args, *rest, **kw)
        self.started, self.ended = time.perf_counter(), None
        threading.Thread(target=self._watch, daemon=True).start()
        _TimedPopen.runs.append(self)

    def _watch(self):
        try:
            os.waitid(os.P_PID, self.pid, os.WEXITED | os.WNOWAIT)
        except ChildProcessError:  # already reaped: its exit is at most this late
            pass
        self.ended = time.perf_counter()


def phase_12(dev, work, smi, path_counts, ckpt, texts_a, texts_b) -> None:
    """Phase 12: the host tools on the card (see the module docstring).
    Adds its paths' launch counts to ``path_counts``; raises on any failed
    check."""
    import numpy as np
    import torch

    from codemix_dense_retrieval_torch.analysis import embedding_space as es
    from codemix_dense_retrieval_torch.io.shards import ShardStore
    from codemix_dense_retrieval_torch.io.tsv import write_queries_tsv
    from codemix_dense_retrieval_torch.models.registry import load_encoder
    from codemix_dense_retrieval_torch.ops import kernels, topk
    from codemix_dense_retrieval_torch.orchestrate.scheduler import load_plan

    t12 = time.perf_counter()
    root = work / "tools"
    rng = np.random.default_rng(SEED + 12)

    # 12a. analyze's card part: EN / ZH / CM query embeddings from phase 6's
    # checkpoint (CM: each EN/ZH pair's words swapped at a random cut), the
    # host metrics of analyze_triplets (the probe and the projections need
    # scikit-learn, which the card's machine may lack: not called), then
    # hubness_stats at its real size on kernel 2's f32 instance
    texts_cm = []
    for ta, tb in zip(texts_a, texts_b):
        wa, wb = ta.split(), tb.split()
        cut = int(rng.integers(1, min(len(wa), len(wb))))
        texts_cm.append(" ".join(wa[:cut] + wb[cut:]))
    enc = load_encoder("BAAI/bge-m3", str(ckpt), device=dev)
    t0 = time.perf_counter()
    e_en, e_zh, e_cm = (enc.encode_queries(t, batch_size=128) for t in (texts_a, texts_b, texts_cm))
    encode_s = time.perf_counter() - t0
    del enc
    torch.cuda.empty_cache()
    r, delta, _, _ = es.line_metrics(e_en, e_zh, e_cm)
    alpha, _, r2 = es.linear_reconstruction(e_en, e_zh, e_cm)
    mid = 0.5 * (e_en + e_zh)
    mid /= np.maximum(np.linalg.norm(mid, axis=1, keepdims=True), 1e-12)
    cos_mid = np.einsum("bd,bd->b", e_cm / np.linalg.norm(e_cm, axis=1, keepdims=True), mid)
    aniso = es.anisotropy(np.vstack([e_en, e_zh, e_cm]), seed=SEED)
    outl = es.detect_outliers(r, delta, cos_mid)
    # r, delta and alpha against a float64 recomputation on the card
    en64, zh64, cm64 = (torch.as_tensor(x, dtype=torch.float64, device=dev) for x in (e_en, e_zh, e_cm))
    axis = zh64 - en64
    r64 = ((cm64 - en64) * axis).sum(1) / (axis * axis).sum(1)
    delta64 = (cm64 - en64 - r64[:, None] * axis).norm(dim=1)
    alpha64 = ((en64 - zh64) * (cm64 - zh64)).sum(1) / (axis * axis).sum(1)
    geo_err = max(float(np.abs(a - b.cpu().numpy()).max()) for a, b in ((r, r64), (delta, delta64), (alpha, alpha64)))
    check(all(np.isfinite(x).all() and x.shape == (N_QUERIES,) for x in (r, delta, alpha, r2, cos_mid)),
          "analyze: non-finite or misshapen per-query metrics")
    check(geo_err <= 1e-5, f"analyze: line metrics differ from the float64 recomputation by {geo_err}")
    check(-1.0 <= aniso["avg_random_cosine"] <= 1.0 and aniso["num_pairs"] > 49_000, f"anisotropy {aniso}")
    check(all(m.shape == (N_QUERIES,) for m in outl.values()), "outlier masks")

    n_hub, hub_max, hub_k = 20_940, 20_000, 10  # 3 x mMARCO dev's 6,980 queries, max_vectors, k
    emb = rng.standard_normal((n_hub, DIM), dtype=np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    spans = []
    real_bin_scores = topk.bin_scores

    def timed_bin_scores(*args, **kw):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = real_bin_scores(*args, **kw)
        e.record()
        spans.append((s, e))
        return out

    topk.bin_scores = timed_bin_scores
    try:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hub = es.hubness_stats(emb, k=hub_k, max_vectors=hub_max, seed=SEED)
        torch.cuda.synchronize()
        hub_s = time.perf_counter() - t0
        path_counts["analyze"] = dict(kernels.LAUNCHES)
    finally:
        topk.bin_scores = real_bin_scores
    kernel_s = sum(s.elapsed_time(e) for s, e in spans) / 1e3
    check(path_counts["analyze"]["bin_scores_transposed_f32"] > 0, "hubness_stats did not launch kernel 2 (f32)")
    # the same sample through the kernel route and the plain one (a stable
    # f32 sort of the full score matrix, TF32 off), outside the count
    sample = emb[np.random.default_rng(SEED).choice(n_hub, size=hub_max, replace=False)]
    x = torch.as_tensor(sample, dtype=torch.float32).to(dev)
    _, kid = topk.topk_ip(x, x, hub_k + 1)
    pv, pid = topk.topk_ip(x, x, hub_k + 2, method="full")
    kid, pid, pv = kid.cpu().numpy(), pid.cpu().numpy(), pv.cpu().numpy()
    del x
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    indeg_k = es.knn_indegree(kid, hub_k)
    loop_s = time.perf_counter() - t0
    check(es.indegree_stats(indeg_k) == hub, "hubness_stats differs from its own route replayed")
    tie = (pv[:, hub_k] - pv[:, hub_k + 1]) <= TOL_F32
    same = np.array([set(a) == set(b) for a, b in zip(kid, pid[:, : hub_k + 1])])
    check(bool(same[~tie].all()), f"{int((~same & ~tie).sum())} rows' neighbours differ from the plain route's "
                                  "past a tie")
    n_tie = int(tie.sum())
    plain = es.indegree_stats(es.knn_indegree(pid[:, : hub_k + 1], hub_k))
    slack = 2 * n_tie / (hub_max * hub_k)  # each tie row moves one unit of in-degree
    check(plain["avg_indegree"] == hub["avg_indegree"] and abs(plain["max_indegree"] - hub["max_indegree"]) <= n_tie
          and abs(plain["gini_indegree"] - hub["gini_indegree"]) <= slack + 1e-12
          and abs(plain["frac_mass_top1pct"] - hub["frac_mass_top1pct"]) <= slack + 1e-12,
          f"hubness {hub} against the plain route's {plain} ({n_tie} tie rows)")
    say("tools_analyze", smi=smi, queries=N_QUERIES, encode_s=round(encode_s, 3), r_mean=float(np.mean(r)),
        delta_mean=float(np.mean(delta)), alpha_mean=float(np.mean(alpha)), r2_mean=float(np.mean(r2)),
        anisotropy=aniso, frac_outlier_delta=float(np.mean(outl["delta_mad"])), line_metrics_err_f64=geo_err,
        probe_and_projection="not run: scikit-learn is not a dependency of the card's path",
        hubness=hub, hubness_rows=[n_hub, hub_max, DIM], hubness_wall_s=round(hub_s, 4),
        hubness_kernel_s=round(kernel_s, 4), hubness_kernel_share=round(kernel_s / hub_s, 4),
        hubness_host_loop_s=round(loop_s, 4), tie_rows=n_tie, tie_rows_differing=int((~same & tie).sum()),
        plain_route_hubness=plain, launches=path_counts["analyze"])

    # 12b. make-plan en-zh-repro -> sweep --slots 2 -> collect -> paper-values
    # over two parallel 131,072-row bf16 stores with one planted row per
    # query (the alpha = .5 mix of its EN / ZH embeddings) and its qrels;
    # 256 of the query pairs: the 21 evaluate steps run one after another
    # in the scheduler's loop, each a process that parses its run
    n_sweep = N_QUERIES // 2
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    planted = rng.choice(SMALL_ROWS, n_sweep, replace=False)
    mix = torch.as_tensor(e_en[:n_sweep] + e_zh[:n_sweep], device=dev)
    docids = [f"s{i}" for i in range(SMALL_ROWS)]
    rows = {}
    for lang in ("en", "zh"):
        rows[lang] = torch.empty((SMALL_ROWS, DIM), dtype=torch.bfloat16)
    for c0 in range(0, SMALL_ROWS, 1 << 16):
        xe = torch.randn(1 << 16, DIM, device=dev, generator=g)
        sel = np.nonzero((planted >= c0) & (planted < c0 + (1 << 16)))[0]
        xe[torch.as_tensor(planted[sel] - c0, device=dev)] = mix[torch.as_tensor(sel, device=dev)]
        xe /= xe.norm(dim=1, keepdim=True)
        u = torch.randn(xe.shape, device=dev, generator=g)
        xz = xe + 0.3 * u / u.norm(dim=1, keepdim=True)
        rows["en"][c0 : c0 + (1 << 16)].copy_(xe.to(torch.bfloat16))
        rows["zh"][c0 : c0 + (1 << 16)].copy_((xz / xz.norm(dim=1, keepdim=True)).to(torch.bfloat16))
    for lang in ("en", "zh"):
        ShardStore.build(rows[lang], docids, lang=lang).save(root / "ix" / lang)
    del rows, mix
    (root / "q").mkdir(parents=True)
    qids = [f"q{i}" for i in range(n_sweep)]
    write_queries_tsv(root / "q" / "queries.en.tsv", zip(qids, texts_a))
    write_queries_tsv(root / "q" / "queries.zh.tsv", zip(qids, texts_b))
    qrels = root / "qrels.tsv"
    qrels.write_text("".join(f"{q}\ts{planted[i]}\t1\n" for i, q in enumerate(qids)))
    t0 = time.perf_counter()
    plan = run_cli_json(["codemix_dense_retrieval_torch", "make-plan", "en-zh-repro", "--index_root", str(root / "ix"),
                         "--query_tsv_root", str(root / "q"), "--result_root", str(root / "res"),
                         "--checkpoint", str(ckpt), "--qrels", str(qrels), "--size", str(SMALL_ROWS),
                         "--out", str(root / "plan.json")])
    plan_s = time.perf_counter() - t0
    check(plan["jobs"] == 3, f"make-plan en-zh-repro gave {plan['jobs']} jobs")
    jobs = load_plan(root / "plan.json")
    saved_pp = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), saved_pp) if p)
    _TimedPopen.runs = []
    real_popen, subprocess.Popen = subprocess.Popen, _TimedPopen
    try:
        t0 = time.perf_counter()
        try:
            swept = run_cli_json(["codemix_dense_retrieval_torch", "sweep", "--plan", str(root / "plan.json"),
                                  "--slots", "2"])
        except SystemExit:
            # the children's output went nowhere: rerun the failed job here
            for job in jobs:
                if not job.complete():
                    run_cli(["codemix_dense_retrieval_torch", *job.argv])
            raise
        sweep_s = time.perf_counter() - t0
    finally:
        subprocess.Popen = real_popen
        if saved_pp is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = saved_pp
    check(sorted(swept["ran"]) == sorted(j.name for j in jobs) and not swept["failed"], f"sweep {swept}")
    job_s = {}
    for p in _TimedPopen.runs:
        if "-m" in p.args and p.args[p.args.index("-m") + 2] != "evaluate":
            check(p.args[p.args.index("-m") + 1] == "codemix_dense_retrieval_torch", f"the sweep ran {p.args}")
            job_s[p.args[p.args.index("-m") + 2] + ":" + p.args[p.args.index("--index") + 1].split("/")[-1]] = (
                round(p.ended - p.started, 2))
    rr10 = {}
    for job in jobs:
        check(job.complete(), f"{job.name}: expected files missing")
        suffix = "_base" if "bilingual" in job.name else ""
        agg = sorted(pathlib.Path(job.outdir).glob(f"cm-alpha-0.5{suffix}_dev_*-agg.json"))[-1]
        rr10[job.name] = json.loads(agg.read_text())["RR@10"]
        check(rr10[job.name] == 100.0, f"{job.name}: RR@10 {rr10[job.name]} at alpha = .5 on planted qrels")
    # the EN job's argv again in this process: kernel 2 counted, and its
    # runs equal the swept ones byte for byte (the subprocess ran the port
    # on the card)
    en_job = next(j for j in jobs if "english" in j.name)
    argv = [a if a != en_job.outdir else str(root / "rerun") for a in en_job.argv]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run_cli(["codemix_dense_retrieval_torch", *argv])
    rerun_s = time.perf_counter() - t0
    path_counts["sweep_en_rerun"] = dict(kernels.LAUNCHES)
    check(path_counts["sweep_en_rerun"]["bin_scores_transposed"] > 0, "the EN job did not launch kernel 2")
    for name in sorted(p.name for p in (root / "rerun").glob("cm-alpha-*.trec")):
        check((root / "rerun" / name).read_bytes() == (pathlib.Path(en_job.outdir) / name).read_bytes(),
              f"the EN job's {name} differs between the sweep and this process")
    t0 = time.perf_counter()
    run_cli(["codemix_dense_retrieval_torch", "collect", "--results_root", str(root / "res"),
             "--out", str(root / "col" / "results.csv")])
    run_cli(["codemix_dense_retrieval_torch", "collect", "--results_root", str(root / "res"),
             "--out", str(root / "col" / "reference.csv"), "--reference_format"])
    collect_s = time.perf_counter() - t0
    for name in ("results.csv", "reference.csv"):
        n_lines = len((root / "col" / name).read_text().splitlines())
        check(n_lines == 1 + 3 * 7, f"collect {name}: {n_lines} lines (3 jobs x 7 alphas + header)")
    t0 = time.perf_counter()
    run_cli(["codemix_dense_retrieval_torch", "paper-values", "--results_root", str(root / "res"),
             "--out", str(root / "paper_values.txt"), "--n_boot", "200"])
    pv_s = time.perf_counter() - t0
    report_lines = len((root / "paper_values.txt").read_text().splitlines())
    check(report_lines > 10, f"paper-values wrote {report_lines} lines")
    say("tools_sweep", smi=smi, store_rows=SMALL_ROWS, hub_rows=2 * SMALL_ROWS, queries=n_sweep,
        make_plan_s=round(plan_s, 3), sweep_wall_s=round(sweep_s, 2), job_s=job_s, rr10_alpha05=rr10,
        rerun_en_s=round(rerun_s, 2), rerun_byte_equal=True, collect_s=round(collect_s, 3),
        paper_values_s=round(pv_s, 3), paper_values_lines=report_lines, launches=path_counts["sweep_en_rerun"])
    shutil.rmtree(root, ignore_errors=True)
    say("phase12", seconds=round(time.perf_counter() - t12, 2))


# phase 13: multi-device on the one card
MESH_SHARDS = 4             # the index's shards in 13a / 13b (all on cuda:0)
ROW_CHUNK_13 = 262_144      # rows per seeded generator of phase 13's index
N_MUTATE = 4096             # rows added, then removed, in 13a's mutation round
TP_BATCH, TP_SEQ = 32, 512  # 13d's Qwen3 forward
# 13c: least pooled cosine of the data-parallel encode against the
# one-device encode (a bf16 model). 13d: int8 TP against the replicated
# int8 forward: the cosine PR 11 measured for int8 against bf16 at full
# width (PERF.md section 6). bf16 TP is held against the f32 forward of the
# same weights, beside the replicated bf16 forward: the replicated bf16
# forward of random Qwen3-0.6B weights is itself only ~0.99991 from the f32
# one (PERF.md section 6, PR 13), so two bf16 computations that round
# differently (TP sums its row-parallel partials) cannot be held to 0.9999
# of each other; the TP forward may stray at most TP_ERR_RATIO times as far
# from the f32 forward, and from the replicated one, as the replicated
# forward strays from the f32 one (1 - least cosine)
MIN_COS_MESH = 0.9999
MIN_COS_TP_INT8 = 0.9989
TP_ERR_RATIO = 2.0


class Rows13:
    """Rows ``[start, stop)`` of phase 13's 8,841,823 x 1024 bf16 index on
    the card: phase 5's recipe (seeded unit rows, one planted row near each
    query pair's alpha = .5 mix, at phase 5's planted positions), with one
    generator per ROW_CHUNK_13 rows (seeds SEED + 130,000 + chunk, apart
    from every other seed of the script, so no row repeats another's), so
    that each process of 13b makes only its own rows. The last chunk made
    is kept for the next call."""

    def __init__(self, dev, planted_pos, planted_rows) -> None:
        self.dev, self.pos, self.rows = dev, planted_pos, planted_rows
        self._chunk = (None, None)

    def chunk(self, c: int):
        import torch

        if self._chunk[0] != c:
            n = min(ROW_CHUNK_13, N_ROWS - c * ROW_CHUNK_13)
            g = torch.Generator(device=self.dev).manual_seed(SEED + 130_000 + c)
            x = torch.randn(n, DIM, device=self.dev, generator=g)
            self._chunk = (c, (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16))
        return self._chunk[1]

    def __call__(self, start: int, stop: int):
        import torch

        out = torch.empty((stop - start, DIM), dtype=torch.bfloat16, device=self.dev)
        for c in range(start // ROW_CHUNK_13, (stop - 1) // ROW_CHUNK_13 + 1):
            lo, hi = max(start, c * ROW_CHUNK_13), min(stop, (c + 1) * ROW_CHUNK_13)
            out[lo - start : hi - start] = self.chunk(c)[lo - c * ROW_CHUNK_13 : hi - c * ROW_CHUNK_13]
        sel = (self.pos >= start) & (self.pos < stop)
        out[self.pos[sel] - start] = self.rows[sel]
        return out


def rows_per_shard_13() -> int:
    """Rows per shard of phase 13's index on MESH_SHARDS shards (2,211,840)."""
    per = -(-N_ROWS // MESH_SHARDS)
    return -(-per // 1024) * 1024


def free_port() -> int:
    """A free TCP port on localhost."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def same_up_to_ties(v1, d1, v2, d2) -> int:
    """Two searches' (scores, docids) are the same: scores equal bit for
    bit, and the docids equal except for order within a run of equal
    scores (a tie goes to the lower row id, and two layouts number the rows
    differently); the last run, which k may cut, is left out. Returns the
    number of queries whose docid order differed."""
    import numpy as np

    check(np.array_equal(v1, v2), "scores differ")
    swapped = 0
    for a, b, v in zip(d1, d2, v1):
        if np.array_equal(a, b):
            continue
        swapped += 1
        above = v > v[-1]  # the run at the k-th score may be cut by k
        va, a, b = v[above], a[above], b[above]
        bounds = np.flatnonzero(np.r_[True, va[1:] != va[:-1], True])
        for s0, s1 in zip(bounds[:-1], bounds[1:]):
            check(set(a[s0:s1]) == set(b[s0:s1]), "docids differ beyond ties")
    return swapped


def phase_13(dev, work, smi, path_counts, ckpt, qdir, mix05, docids, passages, buckets) -> None:
    """Multi-device on the one card: 13a the row-sharded index (4 shards on
    cuda:0) against the one-shard index (bf16 exact, mutation, guaranteed,
    int8, phase 6's store on the transposed route), 13b the multi-process
    search (2 gloo processes of 2 shards each, and 1 NCCL process), 13c
    the data-parallel BGE-M3 encode, 13d Qwen3-0.6B tensor parallelism."""
    import numpy as np
    import torch

    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex
    from codemix_dense_retrieval_torch.io.shards import ShardStore
    from codemix_dense_retrieval_torch.models.encoder import TextEncoder
    from codemix_dense_retrieval_torch.models.registry import load_encoder
    from codemix_dense_retrieval_torch.ops import kernels
    from codemix_dense_retrieval_torch.ops.quant import quantize_rows
    from codemix_dense_retrieval_torch.parallel.mesh import make_mesh
    from codemix_dense_retrieval_torch.parallel.sharded_search import merge_shards, sharded_topk_ip
    from codemix_dense_retrieval_torch.parallel.tp import replicate_params, shard_params_tp

    t13 = time.perf_counter()
    p13 = work / "phase13"
    p13.mkdir()
    mesh1, mesh4 = make_mesh(1, devices=[dev]), make_mesh(MESH_SHARDS, devices=[dev] * MESH_SHARDS)

    # 13a. the rows on one and on four shards of the card
    planted_pos = torch.randperm(N_ROWS, generator=torch.Generator().manual_seed(SEED + 2))[:N_QUERIES].to(dev)
    noise = torch.randn(N_QUERIES, DIM, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED + 1299))
    near = mix05 + 0.5 * noise / noise.norm(dim=1, keepdim=True)
    planted_rows = (near / near.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    rows = Rows13(dev, planted_pos, planted_rows)
    t0 = time.perf_counter()
    host = torch.empty((N_ROWS, DIM), dtype=torch.bfloat16)
    for c0 in range(0, N_ROWS, ROW_CHUNK_13):
        c1 = min(c0 + ROW_CHUNK_13, N_ROWS)
        host[c0:c1].copy_(rows(c0, c1))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ix1 = DenseFlatIndex.build(host, docids).to_device(mesh1)
    torch.cuda.synchronize()
    up1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ix4 = DenseFlatIndex(ix1.store).to_device(mesh4)
    torch.cuda.synchronize()
    up4_s = time.perf_counter() - t0
    rps4 = ix4._rows_per_shard
    check(rps4 == rows_per_shard_13() and len(ix4._docs_dev) == MESH_SHARDS
          and [int(c[0]) for c in ix4._counts_dev] == [rps4] * 3 + [N_ROWS - 3 * rps4], "4-shard layout")
    q = mix05.float()
    kernels.reset_launch_counts()
    steps = {}
    t0 = time.perf_counter()
    exact = {}
    for k in (100, 1000):
        v1, g1 = ix1.search(q, k, return_docids=False, query_block=256)
        v4, g4 = ix4.search(q, k, return_docids=False, query_block=256)
        check(np.array_equal(g1, g4) and np.array_equal(v1, v4), f"4 shards != 1 shard, bf16 exact k={k}")
        exact[k] = (v4, g4)
    check(bool((exact[100][1][:, 0] == planted_pos.cpu().numpy()).mean() > 0.99), "planted rows not found")
    steps["exact_searches_s"] = time.perf_counter() - t0
    q256 = q[:256].to(torch.bfloat16)
    walls = {}
    for k in (100, 1000):
        walls[f"k{k}_1shard_ms"] = cuda_ms(lambda: sharded_topk_ip(q256, ix1._docs_dev, ix1._counts_dev, k), 3)
        walls[f"k{k}_4shards_ms"] = cuda_ms(lambda: sharded_topk_ip(q256, ix4._docs_dev, ix4._counts_dev, k), 3)
        parts = [sharded_topk_ip(q256, d, c, k) for d, c in zip(ix4._docs_dev, ix4._counts_dev)]
        walls[f"k{k}_merge_ms"] = cuda_ms(lambda: merge_shards([p[0] for p in parts], [p[1] for p in parts], k), 20)
    del parts
    # the expected results of 13b, before the mutation
    np.savez(p13 / "expected.npz", v100=exact[100][0], g100=exact[100][1], v1000=exact[1000][0],
             g1000=exact[1000][1])
    torch.save({"planted_pos": planted_pos.cpu(), "planted_rows": planted_rows.cpu(), "queries": q.cpu()},
               p13 / "inputs.pt")

    # the guaranteed tier (kernel 7): each mesh equals its own exact search
    t0 = time.perf_counter()
    for ix in (ix1, ix4):
        ix.enable_sketch(sketch_dim=128, cache=False)
    sketch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in (100, 1000):
        for name, ix in (("1shard", ix1), ("4shards", ix4)):
            gv, gg = ix.search(q, k, return_docids=False, query_block=256, approx="guaranteed")
            check(np.array_equal(gg, exact[k][1]) and np.array_equal(gv, exact[k][0]),
                  f"guaranteed != exact, {name} k={k}")
    cert = {}
    for name, ix in (("1shard", ix1), ("4shards", ix4)):
        ix.search(q, 100, query_block=256, approx=True)
        cert[name] = float(ix.last_certified.mean())
        ix._sketch = None  # the sidecar leaves the card before the mutation round
    torch.cuda.empty_cache()
    steps["guaranteed_searches_s"] = time.perf_counter() - t0

    # the int8 store (kernel 4): the one-shard index's rows quantized on the
    # card one chunk at a time, uploaded on both meshes
    t0 = time.perf_counter()
    host8 = torch.empty((N_ROWS, DIM), dtype=torch.int8)
    scales8 = torch.empty(N_ROWS, dtype=torch.float32)
    for c0 in range(0, N_ROWS, 1 << 20):
        v8, s8 = quantize_rows(ix1._docs_dev[0][c0 : min(c0 + (1 << 20), N_ROWS)])
        host8[c0 : c0 + len(v8)].copy_(v8)
        scales8[c0 : c0 + len(v8)].copy_(s8)
    del host, v8, s8
    store8 = ShardStore.build(host8, docids, dtype="int8", scales=scales8.numpy())
    ix8_1, ix8_4 = DenseFlatIndex(store8).to_device(mesh1), DenseFlatIndex(store8).to_device(mesh4)
    int8_s = time.perf_counter() - t0
    for k in (100, 1000):
        v1, g1 = ix8_1.search(q, k, return_docids=False, query_block=256)
        v4, g4 = ix8_4.search(q, k, return_docids=False, query_block=256)
        check(np.array_equal(g1, g4) and np.array_equal(v1, v4), f"4 shards != 1 shard, int8 k={k}")
    del ix8_1, ix8_4, store8, host8, scales8
    torch.cuda.empty_cache()

    # one mutation round on each mesh: add (both indexes grow: 1,441 rows of
    # the 4 shards' pad and 417 of the one shard's are spare), remove,
    # rebalance (rows move between the 4 shards). The one-shard index's
    # results are kept and it leaves the card before the 4-shard index
    # grows (two grown indexes and a score store do not fit in 80 GB)
    t_mut = time.perf_counter()
    gm = torch.Generator(device=dev).manual_seed(SEED + 1302)
    new = torch.randn(N_MUTATE, DIM, device=dev, generator=gm)
    new /= new.norm(dim=1, keepdim=True)
    new_ids = [f"m{i}" for i in range(N_MUTATE)]
    gone = [str(i) for i in np.random.default_rng(SEED + 1303).choice(N_ROWS, N_MUTATE, replace=False)]
    mut_s, mutated, grown = {}, {}, {}
    for name in ("1shard", "4shards"):
        ix = ix1 if name == "1shard" else ix4
        ix1 = None
        t0 = time.perf_counter()
        ix.add(new, new_ids)
        ix.remove(gone)
        ix.rebalance()
        torch.cuda.synchronize()
        mut_s[name] = time.perf_counter() - t0
        grown[name] = ix._rows_per_shard
        check(ix.count == N_ROWS, f"{name} count after the mutation round")
        t0 = time.perf_counter()
        mutated[name] = {k: ix.search(q, k, query_block=256) for k in (100, 1000)}
        steps[f"mutated_searches_{name}_s"] = time.perf_counter() - t0
        # each added row finds itself; no removed row is found
        check(ix.search(new[:64], 1)[1][:, 0].tolist() == new_ids[:64], f"{name}: added rows not found")
        gone_set = set(gone)
        check(not any(d in gone_set for d in mutated[name][1000][1].ravel()), f"{name}: a removed row was found")
        t0 = time.perf_counter()
        del ix
        torch.cuda.empty_cache()
        steps[f"free_{name}_s"] = time.perf_counter() - t0
    counts4 = [int(c[0]) for c in ix4._counts_dev]
    per = -(-N_ROWS // MESH_SHARDS)
    check(counts4 == [per] * 3 + [N_ROWS - 3 * per], f"rebalanced counts {counts4}")
    swaps = {f"k{k}": same_up_to_ties(*mutated["1shard"][k], *mutated["4shards"][k]) for k in (100, 1000)}
    del ix4, mutated
    torch.cuda.empty_cache()
    steps["mutation_and_searches_s"] = time.perf_counter() - t_mut

    # phase 6's 131,072-row store: 32,768 rows a shard, the transposed route (kernel 2)
    t0 = time.perf_counter()
    small1 = DenseFlatIndex.load(work / "small").to_device(mesh1)
    small4 = DenseFlatIndex.load(work / "small").to_device(mesh4)
    check(small4._rows_per_shard == SMALL_ROWS // MESH_SHARDS, "phase 6's store: 32,768 rows a shard")
    for k in (100, 1000):
        v1, g1 = small1.search(q, k, return_docids=False, query_block=256)
        v4, g4 = small4.search(q, k, return_docids=False, query_block=256)
        check(np.array_equal(g1, g4) and np.array_equal(v1, v4), f"4 shards != 1 shard, small store k={k}")
    del small1, small4
    torch.cuda.empty_cache()
    steps["small_store_s"] = time.perf_counter() - t0
    path_counts["multi_device"] = dict(kernels.LAUNCHES)
    for name in ("binmax_only", "cover_rescore", "bin_scores_transposed", "bin_scores_int8_bin_major", "binub",
                 "super_select"):
        check(path_counts["multi_device"][name] > 0, f"13a did not launch {name}")
    say("multi_device", smi=smi, rows=N_ROWS, shards=MESH_SHARDS, rows_per_shard=rps4,
        gen_s=round(gen_s, 2), upload_1shard_s=round(up1_s, 2), upload_4shards_s=round(up4_s, 2),
        note="the 4 shards share one card and run one after another: the block walls are the cost "
             "of sharding on one card, not a speed-up",
        block_256=walls, sketch_build_s=round(sketch_s, 2), certified_frac_k100=cert,
        mutation_s=mut_s, rows_per_shard_after_growing=grown, mutated_tie_order_swaps=swaps,
        int8_build_s=round(int8_s, 2), steps={kk: round(vv, 2) for kk, vv in steps.items()},
        ids_and_values_equal=True, phase13a_s=round(time.perf_counter() - t13, 2),
        launches=path_counts["multi_device"])

    # 13b. the multi-process search: 2 processes of 2 shards each (gloo: NCCL
    # refuses two ranks on one card), then 1 process of 4 shards on NCCL
    t0 = time.perf_counter()
    jobs, ports = [], {2: free_port(), 1: free_port()}
    for rank, world, backend, local in ((0, 2, "gloo", 2), (1, 2, "gloo", 2), (0, 1, "nccl", 4)):
        port = ports[world]
        jobs.append(subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--phase13-worker", str(rank), str(world), str(port),
             backend, str(local), str(p13)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in jobs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in jobs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = []
    for p, out in zip(jobs, outs):
        last = [ln for ln in out.splitlines() if ln.startswith("{")]
        check(p.returncode == 0 and bool(last), f"13b worker rc {p.returncode}:\n{out[-4000:]}")
        ranks.append(json.loads(last[-1]))
    mp_s = time.perf_counter() - t0
    say("multi_process", smi=smi, ranks=ranks, wall_s=round(mp_s, 2), results_equal_13a=True)

    # 13c. data-parallel encode: phase 6's BGE-M3 checkpoint, the passages of
    # phase 4 at the 1024 bucket, two replicas sharing cuda:0
    t0 = time.perf_counter()
    enc = load_encoder("BAAI/bge-m3", str(ckpt), device=dev)
    enc.length_buckets = buckets
    dp_mesh = make_mesh(2, devices=[dev] * 2)
    enc_dp = TextEncoder("BAAI/bge-m3", enc.cfg, enc.model.state_dict(), enc.tokenizer, length_buckets=buckets,
                         mesh=dp_mesh)
    check(enc_dp._replicas[0] is enc_dp._replicas[1], "repeated devices must share one replica")
    load13c_s = time.perf_counter() - t0
    enc.encode_documents(passages[:4], batch_size=32, max_length=1024)
    enc_dp.encode_documents(passages[:4], batch_size=32, max_length=1024)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = enc.encode_documents(passages, batch_size=32, max_length=1024)
    one_s = time.perf_counter() - t0
    one_launches = kernels.LAUNCHES["flash_attention"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    par = enc_dp.encode_documents(passages, batch_size=32, max_length=1024)
    par_s = time.perf_counter() - t0
    path_counts["multi_device_dp"] = dict(kernels.LAUNCHES)
    dp_launches = path_counts["multi_device_dp"]["flash_attention"]
    check(one_launches > 0 and dp_launches == 2 * one_launches,
          f"kernel B per replica chunk: {dp_launches} launches vs {one_launches} on one device")
    check(par.shape == one.shape == (N_PASSAGES, DIM) and bool(np.isfinite(par).all()), "dp encode shape")
    dp_cos = float((one * par).sum(axis=1).min())
    check(dp_cos >= MIN_COS_MESH, f"dp encode vs one device: min cos {dp_cos}")
    say("multi_device_encode", smi=smi, passages=N_PASSAGES, dp=2, load_s=round(load13c_s, 2),
        one_device_s=round(one_s, 2),
        dp_s=round(par_s, 2), min_cos=dp_cos, max_abs=float(np.abs(one - par).max()),
        kernel_b_launches={"one_device": one_launches, "dp": dp_launches})
    del enc, enc_dp
    torch.cuda.empty_cache()

    # 13d. tensor parallelism: Qwen3-0.6B (16 / 8 heads of 128) over a tp = 2
    # mesh on the card, 8 / 4 heads per half, bf16 and int8
    qwen = "Qwen/Qwen3-Embedding-0.6B"
    tp_mesh = make_mesh(1, 2, devices=[dev] * 2)
    tp = {}
    exact_f32 = None

    def least_cos(a, b) -> float:
        return float(torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=1).min())

    for mode in ("bf16", "int8"):
        t0 = time.perf_counter()
        qenc = load_encoder(qwen, str(qdir), weight_quant=None if mode == "bf16" else mode, device=dev)
        load_s = time.perf_counter() - t0
        g13 = torch.Generator(device=dev).manual_seed(SEED + 1304)
        ids = torch.randint(3, qenc.cfg.vocab_size, (TP_BATCH, TP_SEQ), device=dev, generator=g13)
        mask = torch.ones_like(ids)
        mask[1::2, TP_SEQ // 2 + 7:] = 0  # every second row ragged
        model = replicate_params(qenc.model, tp_mesh)[0]
        tp_model = shard_params_tp(qenc.model, tp_mesh, "qwen3")
        halves = {type(layer.self_attn).__name__ for layer in tp_model.layers}
        check(halves == {"TensorParallel"}, f"{mode}: the attention did not split ({halves})")
        with torch.inference_mode():
            kernels.reset_launch_counts()
            rep = model(ids, mask)
            rep_launches = kernels.LAUNCHES["flash_attention_causal"]
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = tp_model(ids, mask)
            torch.cuda.synchronize()
            tp_s = time.perf_counter() - t0
            path_counts[f"multi_device_tp_{mode}"] = dict(kernels.LAUNCHES)
            rep_ms = cuda_ms(lambda: model(ids, mask), 2)
            tp_ms = cuda_ms(lambda: tp_model(ids, mask), 2)
        tp_launches = path_counts[f"multi_device_tp_{mode}"]["flash_attention_causal"]
        check(rep_launches == qenc.cfg.num_layers and tp_launches == 2 * rep_launches,
              f"{mode}: kernel B causal {tp_launches} launches over the halves, {rep_launches} replicated")
        cos = least_cos(got, rep)
        check(bool(torch.isfinite(got).all()), f"{mode} TP forward not finite")
        extra = {}
        if mode == "bf16":
            # the same weights in f32 with plain attention: the reference both
            # bf16 forwards are measured against
            f32_model = load_encoder(qwen, str(qdir), dtype=torch.float32, use_flash=False, device=dev).model
            with torch.inference_mode():
                exact_f32 = f32_model(ids, mask)
            del f32_model
            rep_err, tp_err = 1.0 - least_cos(rep, exact_f32), 1.0 - least_cos(got, exact_f32)
            check(tp_err <= TP_ERR_RATIO * rep_err and 1.0 - cos <= TP_ERR_RATIO * rep_err,
                  f"bf16 TP: 1 - cos {1.0 - cos} vs replicated, {tp_err} vs f32; replicated vs f32 {rep_err}")
            extra = dict(replicated_vs_f32_min_cos=1.0 - rep_err, tp_vs_f32_min_cos=1.0 - tp_err)
        else:
            check(cos >= MIN_COS_TP_INT8, f"int8 TP vs replicated: min cos {cos}")
        tp[mode] = dict(load_s=round(load_s, 2), min_cos=cos, **extra,
                        max_abs=float((got.float() - rep.float()).abs().max()),
                        forward_tp_ms=tp_ms, forward_replicated_ms=rep_ms, first_tp_s=round(tp_s, 3),
                        kernel_b_causal_launches={"replicated": rep_launches, "tp": tp_launches})
        del qenc, model, tp_model, rep, got
        torch.cuda.empty_cache()
    del exact_f32
    say("multi_device_tp", smi=smi, model="Qwen3-Embedding-0.6B", batch=TP_BATCH, seq=TP_SEQ, tp=2,
        heads_per_half="8 / 4", **tp)
    say("phase13", seconds=round(time.perf_counter() - t13, 2))


def phase_13_worker(argv) -> None:
    """One process of 13b: ``rank world port backend local_shards dir``. It
    joins the world, makes only its own rows (``rows_fn`` asserts its
    window), searches at k = 100 and 1000 and holds the results against
    13a's; prints one JSON line (its wall and the payload it gathered)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from codemix_dense_retrieval_torch.parallel import multihost
    from codemix_dense_retrieval_torch.parallel.sharded_search import _merge_two_key, search_blocks, sharded_topk_ip

    rank, world, port, backend, local, p13 = (int(argv[0]), int(argv[1]), int(argv[2]), argv[3], int(argv[4]),
                                               pathlib.Path(argv[5]))
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    inputs = torch.load(p13 / "inputs.pt")
    want = np.load(p13 / "expected.npz")
    check(multihost.initialize_multihost(f"localhost:{port}", world, rank, backend=backend), "init")
    check(dist.get_backend() == backend and dist.get_world_size() == world, "world")
    mesh = multihost.global_mesh(local_devices=[dev] * local)
    check(mesh.shape["shard"] == MESH_SHARDS and mesh.first_shard == rank * local, f"mesh {mesh}")
    rows = Rows13(dev, inputs["planted_pos"].to(dev), inputs["planted_rows"].to(dev))
    asked = []

    def rows_fn(start, stop):
        window = multihost.process_local_rows(N_ROWS, rows_per_shard_13(), mesh)
        check(window.start <= start and stop <= window.stop, f"rows [{start}, {stop}) outside {window}")
        asked.append(stop - start)
        return rows(start, stop)

    t0 = time.perf_counter()
    docs, counts, rps = multihost.shard_rows_multihost(rows_fn, N_ROWS, DIM, torch.bfloat16, mesh)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    check(rps == rows_per_shard_13() and sum(asked) == sum(int(c[0]) for c in counts), "local rows")
    gathered = []
    real = dist.all_gather_into_tensor

    def recording(out, src, *a, **kw):
        gathered.append(src.numel() * src.element_size())
        return real(out, src, *a, **kw)

    dist.all_gather_into_tensor = recording
    q = inputs["queries"].to(dev)
    walls = {}
    for k in (100, 1000):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals, gids = search_blocks(
            q, 256, rps, lambda blk: sharded_topk_ip(blk.to(torch.bfloat16), docs, counts, k, mesh=mesh),
            mesh.shard_devices(), mesh)
        v, g = vals.cpu().numpy(), gids.cpu().numpy()
        walls[f"k{k}_s"] = round(time.perf_counter() - t0, 4)
        check(np.array_equal(g, want[f"g{k}"]) and np.array_equal(v, want[f"v{k}"]), f"rank {rank} k={k} != 13a")
        if world == 1:
            # one process: the merge needs no collective, so run NCCL's
            # all-gather and all-reduce on the (B, k) payload explicitly
            vv, gg = multihost.all_gather_candidates(vals[:256], gids[:256], mesh)
            mv, mg = _merge_two_key(vv, gg, k)
            check(torch.equal(mv, vals[:256]) and torch.equal(mg, gids[:256]), "NCCL all-gather round trip")
            check(torch.equal(multihost.all_reduce_max(vals[:, -1], mesh), vals[:, -1]), "NCCL all-reduce")
    dist.all_gather_into_tensor = real
    check(bool(gathered) and max(gathered) <= 256 * 1000 * 8, f"a gather moved {max(gathered)} bytes")
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "world": world, "backend": backend, "local_shards": local,
                      "upload_s": round(upload_s, 2), "search": walls, "gathers": len(gathered),
                      "payload_bytes": sum(gathered), "wall_s": round(time.perf_counter() - t_start, 2),
                      "ok": True}), flush=True)


# phase 14: the rows of each (dtype, seed), made on the card; ties planted
# for 16 queries (a block of TIE_ROWS copies of one row near the query) and
# across n_valid (copies of a 17th query's row, the pad rows included)
RESCORE_SEEDS = (SEED + 141, SEED + 142, SEED + 143)
N_PAD = -(-N_ROWS // 1024) * 1024
TIE_QUERIES = 16
TIE_ROWS = 160              # 20 bins of 8: k = 10 cuts through them, k = 100 holds them


def rescore_operands(dtype, seed: int, dev):
    """(1024 unit queries, N_PAD x DIM unit rows) of ``dtype`` on the card
    from ``seed``: query b < TIE_QUERIES has TIE_ROWS copies of
    normalize(q_b + 0.5 u) at a seeded place, and the rows from N_ROWS - 40
    to the end (pad rows included) are copies of query TIE_QUERIES' such
    row, so equal bin maxima straddle the k-th bin and n_valid."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def unit(n):
        x = torch.randn(n, DIM, generator=g, device=dev)
        return x / x.norm(dim=1, keepdim=True)

    q = unit(1024)
    docs = torch.empty(N_PAD, DIM, dtype=dtype, device=dev)
    for r0 in range(0, N_PAD, 262_144):
        r1 = min(r0 + 262_144, N_PAD)
        docs[r0:r1] = unit(r1 - r0).to(dtype)
    near = q[: TIE_QUERIES + 1] + 0.5 * unit(TIE_QUERIES + 1)
    near = (near / near.norm(dim=1, keepdim=True)).to(dtype)
    offsets = torch.randint(0, 100_000, (TIE_QUERIES,), generator=g, device=dev).tolist()
    for b in range(TIE_QUERIES):
        r0 = (b + 1) * 500_000 + offsets[b]
        docs[r0 : r0 + TIE_ROWS] = near[b]
    docs[N_ROWS - 40 :] = near[TIE_QUERIES]
    return q.to(dtype).contiguous(), docs


def phase_cover_rescore(dev, smi, path_counts) -> dict:
    """Phase 14: cover_rescore against kernel A's score store, bit for bit,
    and the route without the store against the stored route (see the
    module docstring). Returns the kernel table's cover_rescore entry."""
    import torch

    from codemix_dense_retrieval_torch.ops import kernels, topk

    nv = torch.tensor([N_ROWS], dtype=torch.int32, device=dev)
    m = topk._auto_super_size(100)
    report = {}
    mismatches = 0
    for dtype, label in ((torch.bfloat16, "bf16"), (torch.float16, "f16")):
        for seed in RESCORE_SEEDS:
            q, docs = rescore_operands(dtype, seed, dev)
            out = {}
            # kernel A's store, kernel 5's maxima and the rescored bins at
            # each of kernel A's query tiles (n128 at 256 and 100, n64 at 48)
            for b in (256, 100, 48):
                qb = q[:b].contiguous()
                s, bm = topk.bin_scores(qb, docs, nv, 8)
                bm5 = topk.binmax_only(qb, docs, nv, 8)
                check(torch.equal(bm5.view(torch.int32), bm.view(torch.int32)),
                      f"{label} seed {seed} B={b}: kernel 5's bin maxima differ from kernel A's")
                for kb in (100, 1000):
                    ids = topk._select_bins_two_level(bm5, kb, m)
                    got = topk.cover_rescore(qb, docs, ids, 8, nv).view(torch.int32)
                    want = topk._gather_bins(s, ids, 8).view(torch.int32)
                    bad = int((got != want).sum())
                    mismatches += bad
                    out[f"B{b}_kb{kb}_bits_differ"] = bad
                    if b == 256 and kb == 100:
                        plain = topk.cover_rescore_plain(qb, docs, ids, 8, nv)
                        err = (got.view(torch.float32) - plain).abs().max().item()
                        check(err <= 1e-4, f"{label} cover_rescore vs plain err {err}")
                        out["vs_plain_max_abs_err"] = err
                        # every planted tie's query: its top k is inside the tie block
                        out["tie_bins_selected"] = int((bm5[:TIE_QUERIES].gather(1, ids[:TIE_QUERIES])
                                                        == bm5[:TIE_QUERIES].amax(1, keepdim=True)).sum())
                del s, bm, bm5
            # the two routes over 1024 queries in 256-query launches
            kernels.reset_launch_counts()
            for k in (10, 100, 1000):
                mk = topk._auto_super_size(k)
                v1, i1 = topk.topk_ip_bins_two_level(q, docs, k, bin_size=8, super_size=mk, tile_b=256, n_valid=nv)
                v0, i0 = topk._by_query_chunks(q, 256, lambda qq: topk._topk_from_bins_two_level_bm(
                    *topk.bin_scores(qq, docs, nv, 8), k, 8, mk))
                same = torch.equal(i1, i0) and torch.equal(v1.view(torch.int32), v0.view(torch.int32))
                check(same, f"{label} seed {seed} k={k}: the rescored route's results differ from the stored route's")
                out[f"k{k}_equal"] = same
            sfx = kernels.dtype_suffix(dtype)
            counts = dict(kernels.LAUNCHES)
            check(counts["cover_rescore" + sfx] == 12 and counts["binmax_only" + sfx] == 12,
                  f"{label}: the rescored route launched {counts['binmax_only' + sfx]} / {counts['cover_rescore' + sfx]}")
            path_counts[f"bits.cover_rescore_{label}_{seed}"] = counts
            report[f"{label}_{seed}"] = out
            if not (dtype == torch.bfloat16 and seed == RESCORE_SEEDS[0]):
                del q, docs
                torch.cuda.empty_cache()
                continue
            # times at the main path's shape (bf16, B = 256, k = 100: 800 rows a query)
            q256 = q[:256].contiguous()
            bm5 = topk.binmax_only(q256, docs, nv, 8)
            ids = topk._select_bins_two_level(bm5, 100, m)
            del bm5
            ms = kernel_ms(lambda: topk.cover_rescore(q256, docs, ids, 8, nv), 20)
            plain = cuda_ms(lambda: topk.cover_rescore_plain(q256, docs, ids, 8, nv), 3)
            c = ids.numel() * 8
            b_ms, b_by = bound(c * DIM * 2 + 256 * DIM * 2 + c * 4 + ids.numel() * 8, 2 * c * DIM)
            stored = kernel_ms(lambda: topk._topk_from_bins_two_level_bm(
                *topk.bin_scores(q256, docs, nv, 8), 100, 8, m), 3)
            rescored = kernel_ms(lambda: topk.topk_ip_bins_two_level(
                q256, docs, 100, bin_size=8, super_size=m, tile_b=256, n_valid=nv), 3)
            kernel_a = kernel_ms(lambda: topk.bin_scores(q256, docs, nv, 8), 3)
            kernel_5 = kernel_ms(lambda: topk.binmax_only(q256, docs, nv, 8), 3)
            entry = dict(
                name="cover_rescore", route="cuda", source="codemix_dense_retrieval_torch/csrc/cover_rescore.cu",
                replaces="none (the exact route's read of kernel A's score store at the covered bins)",
                launches=0, max_abs_err=out["vs_plain_max_abs_err"], **ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"B=256 k=100 G=8 ({c // 256} rows a query) N={N_PAD} d={DIM} bf16",
            )
            report["times"] = dict(cover_rescore=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                   kernel_a=kernel_a, kernel_5=kernel_5, chunk_k100_stored=stored,
                                   chunk_k100_rescored=rescored)
            del q, docs, q256, ids
            torch.cuda.empty_cache()
    check(mismatches == 0, f"cover_rescore differs from kernel A's store in {mismatches} scores")
    say("cover_rescore", smi=smi, rows=N_ROWS, rows_padded=N_PAD, dim=DIM, seeds=list(RESCORE_SEEDS),
        super_size=m, tie_queries=TIE_QUERIES, tie_rows=TIE_ROWS, **report)
    return entry


# phase 15: f32 bin maxima made on the card with ties planted (select_operands)
SELECT_SEEDS = (SEED + 151, SEED + 152, SEED + 153)
SELECT_NB = N_PAD // 8      # the cell's bins a query at G = 8: 1,105,280


def select_operands(b: int, nb: int, m: int, seed: int, dev):
    """(b, nb) f32 bin maxima on the card from ``seed``, shaped like kernel
    5's (values around 0.05, NEG_INF from a ragged n_valid on), with ties
    planted in the first rows: row 0 has 40 supers of one high maximum at
    seeded places (k = 10 cuts through them); row 1 is one value
    throughout; in row 2 every value is negative and 60 supers reach +0.0
    or -0.0, some with both zeros among their bins, in either order; row 3
    holds NaNs of both signs, one super three of them; in row 4 all but
    50 supers are NEG_INF (fewer valid supers than k = 100 or 1000); in row
    5 the best 3,000 supers lie side by side (the k-th group maximum falls
    far below the k-th super)."""
    import torch

    from codemix_dense_retrieval_torch.ops import topk

    g = torch.Generator(device=dev).manual_seed(seed)
    bm = torch.randn(b, nb, generator=g, device=dev) * 0.03 + 0.05
    ns = nb // m
    nv = nb - int(torch.randint(1, min(nb, 4 * m * 32), (1,), generator=g, device=dev))
    bm[:, nv:] = topk.NEG_INF
    bits = bm.view(torch.int32)
    pick = lambda n: torch.randperm(max(ns - 64, 1), generator=g, device=dev)[:n]
    if b > 0:
        sup = pick(40)
        bm[0].view(ns, m)[sup] = 0.0
        bm[0].view(ns, m)[sup, int(seed) % m] = 0.9
    if b > 1:
        bm[1] = 0.25
    if b > 2:
        bm[2] = -bm[2].abs() - 0.01
        sup = pick(60)
        r2 = bits[2].view(ns, m)
        for j, s_ in enumerate(sup.tolist()):
            r2[s_, j % m] = 0 if j % 3 == 0 else -(1 << 31)
            if j % 2 == 1 and m > 1:
                r2[s_, (j + 1) % m] = -(1 << 31) if j % 3 == 0 else 0
    if b > 3:
        sup = pick(4).tolist()
        for s_, v in zip(sup, (0x7FC00001, 0x7F800005, 0xFFC00003 - (1 << 32), 0x7FC00001)):
            bits[3].view(ns, m)[s_, 0] = v
        if m > 2:  # two NaNs in one super
            bits[3].view(ns, m)[sup[0], 1] = 0x7F800005
            bits[3].view(ns, m)[sup[0], m - 1] = 0xFFC00003 - (1 << 32)
    if b > 4:
        keep = pick(50)
        row = torch.full((ns, m), topk.NEG_INF, device=dev)
        row[keep] = bm[4].view(ns, m)[keep]
        bm[4] = row.view(-1)
    if b > 5 and ns > 3_100:
        bm[5].view(ns, m)[17:3_017] += 1.0
    return bm


def phase_super_select(dev, smi, path_counts) -> dict:
    """Phase 15: super_select against its plain version, bit for bit, and
    the exact route with it against the route with the plain super level
    (see the module docstring). Returns the kernel table's super_select
    entry."""
    import torch

    from codemix_dense_retrieval_torch.ops import kernels, topk

    report, bad = {}, 0
    shapes = [(256, SELECT_NB, 8, k) for k in (10, 100, 1000)]
    shapes += [(256, SELECT_NB, m, k) for m in (4, 16) for k in (10, 100, 1000)]
    shapes += [(b, SELECT_NB, 8, k) for b in (1, 100, 257) for k in (10, 100, 1000)]
    shapes += [(64, SELECT_NB, 8, 4095), (7, 8 * 50, 8, 100), (7, 8 * 101, 8, 100), (7, 8 * 100, 8, 100),
               (5, 4 * 3_000, 4, 1000)]
    # past SUPER_SELECT_MAX_K supers kept: the sort in device memory
    shapes += [(64, SELECT_NB, 8, 4096), (7, SELECT_NB, 16, 20_000), (5, 4 * 6_000, 4, 10**6),
               (3, 8 * 5_000, 8, 5_000)]
    kernels.reset_launch_counts()
    for seed in SELECT_SEEDS:
        out = {}
        for b, nb, m, k in shapes:
            bm = select_operands(b, nb, m, seed, dev)
            v1, i1 = topk.super_select(bm, k, m)
            v0, i0 = topk.super_select_plain(bm, k, m)
            rows = int(((v1.view(torch.int32) != v0.view(torch.int32)).any(1) | (i1 != i0).any(1)).sum())
            bad += rows
            out[f"B{b}_nb{nb}_M{m}_k{k}"] = rows
            if rows:
                r = int(((v1.view(torch.int32) != v0.view(torch.int32)).any(1) | (i1 != i0).any(1)).nonzero()[0])
                say("select_mismatch", seed=seed, b=b, nb=nb, m=m, k=k, row=r,
                    kernel_ids=i1[r, :12].tolist(), plain_ids=i0[r, :12].tolist(),
                    kernel_bits=[hex(x & 0xFFFFFFFF) for x in v1[r, :12].view(torch.int32).tolist()],
                    plain_bits=[hex(x & 0xFFFFFFFF) for x in v0[r, :12].view(torch.int32).tolist()])
            del bm, v0, i0, v1, i1
        report[str(seed)] = out
    check(kernels.LAUNCHES["super_select"] == 3 * len(shapes),
          f"super_select launched {kernels.LAUNCHES['super_select']} times, not {3 * len(shapes)}")
    path_counts["bits.super_select"] = dict(kernels.LAUNCHES)
    say("super_select_bits", smi=smi, rows_differ=bad, seeds=list(SELECT_SEEDS), shapes=len(shapes), **report)
    check(bad == 0, f"super_select differs from its plain version in {bad} rows")

    # the exact route over 1024 queries of phase 14's bf16 index: the
    # kernel's super level against the plain one
    nv = torch.tensor([N_ROWS], dtype=torch.int32, device=dev)
    q, docs = rescore_operands(torch.bfloat16, RESCORE_SEEDS[0], dev)
    routes = {}
    card = topk.super_select
    for k in (10, 100, 1000):
        mk = topk._auto_super_size(k)
        kernels.reset_launch_counts()
        v1, i1 = topk.topk_ip_bins_two_level(q, docs, k, bin_size=8, super_size=mk, tile_b=256, n_valid=nv)
        launched = kernels.LAUNCHES["super_select"]
        topk.super_select = topk.super_select_plain
        try:
            v0, i0 = topk.topk_ip_bins_two_level(q, docs, k, bin_size=8, super_size=mk, tile_b=256, n_valid=nv)
        finally:
            topk.super_select = card
        same = torch.equal(i1, i0) and torch.equal(v1.view(torch.int32), v0.view(torch.int32))
        check(launched == 4, f"k={k}: the exact route launched super_select {launched} times, not 4")
        check(same, f"k={k}: the exact route with super_select differs from the plain super level")
        routes[f"k{k}_equal"] = same

    # times at the main path's shape, on kernel 5's bin maxima
    q256 = q[:256].contiguous()
    m = topk._auto_super_size(100)
    bm5 = topk.binmax_only(q256, docs, nv, 8)
    del q, docs
    torch.cuda.empty_cache()
    b, nb = bm5.shape
    ms = kernel_ms(lambda: topk.super_select(bm5, 100, m), 20)
    plain = kernel_ms(lambda: topk.super_select_plain(bm5, 100, m), 5)
    library = cuda_ms(lambda: torch.topk(bm5.view(b, -1, m).amax(dim=2), 101, dim=1), 5)
    ng = -(-(nb // m) // 32)
    b_ms, b_by = bound(b * nb * 4 + b * ng * 4 + b * (101 * 4 + 100 * 8), 0)
    entry = dict(
        name="super_select", route="cuda", source="codemix_dense_retrieval_torch/csrc/super_select.cu",
        replaces="none (the two-level cover's super-max reduce and whole-row stable sort)",
        launches=0, **ms, plain_ms=plain["ms"], bound_ms=b_ms, bound_by=b_by, library_ms=library,
        shape=f"B={b} nb={nb} M={m} k_bins=100 f32 bin maxima",
    )
    say("super_select", smi=smi, rows=N_ROWS, bins=nb, super_size=m, routes=routes,
        times=dict(super_select=ms, plain=plain, library_amax_topk_ms=library, bound_ms=b_ms, bound_by=b_by))
    del bm5
    torch.cuda.empty_cache()
    return entry


KDA_SEEDS = (SEED + 161, SEED + 162)
# kda_chunk vs its plain version, both bf16 out: the kernel's products with
# the state and with U round their operands to TF32 (~2^-11 relative each,
# over sums of 128 and 64 terms), and both outputs round to bf16 (2^-9); a
# wrong mask, sign or decay moves the output by its own size
TOL_KDA_REL = 1e-2


def kda_operands(b: int, s: int, h: int, seed: int, dev):
    """q, k (unit; q scaled by 128^-1/2), v bf16 (B, S, H, 128); per-step log
    decays g f32 from 0 to -20: channel c's rate spans 0 and 1e-3 to 20,
    times U(0, 1), with head 0 at exactly -20 everywhere; beta f32 U(0, 1),
    with exact 0 and 1 planted."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    q = torch.nn.functional.normalize(randn(b, s, h, 128), dim=-1) * 128 ** -0.5
    k = torch.nn.functional.normalize(randn(b, s, h, 128), dim=-1)
    v = randn(b, s, h, 128)
    rate = torch.cat([torch.zeros(1, device=dev), torch.logspace(-3, math.log10(20.0), 127, device=dev)])
    g = -torch.rand(b, s, h, 128, generator=gen, device=dev) * rate
    g[:, :, 0] = -20.0
    beta = torch.rand(b, s, h, generator=gen, device=dev)
    beta[:, ::7] = 0.0
    beta[:, 3::7] = 1.0
    return q.bfloat16(), k.bfloat16(), v.bfloat16(), g.contiguous(), beta.contiguous()


def kda_counts(tokens, heads: int = 32, d: int = 128, chunk: int = 64):
    """(bytes, operations) of the scan over sequences of ``tokens`` tokens:
    q, k, v, o bf16 and g, beta f32 once a token and head; the chunk form's
    products (benchmark/metrics/kda_chunk_roofline.py counts the same)."""
    nbytes = ops = 0.0
    for t in tokens:
        nbytes += t * heads * (4 * d * 2 + d * 4 + 4)
        for c0 in range(0, t, chunk):
            n = min(chunk, t - c0)
            first, last = c0 == 0, c0 + chunk >= t
            ops += 2.0 * d * n * n                     # A and P
            ops += 1.0 * n * n * d                     # the triangular solve of U
            ops += 2.0 * d * n * (n + 1) / 2           # P U
            ops += 0 if first else 2.0 * 2 * n * d * d  # beta K^ S0 and Q^ S0
            ops += 0 if last else 2.0 * n * d * d       # the next state
    return nbytes, ops * heads


# kda_ops / moe_rows against their plain versions (f32 inside both, each
# output rounded to bf16 once): every element at most one bf16 rounding
# (2^-7 of itself) from the other, plus 2^-7 of 1% of the case's largest
# value where f32 sums cancel; moe_act rounds twice (SiLU, then the
# product), as torch does
TOL_ROUNDINGS = {"kda_conv": 1.0, "kda_out": 1.0, "moe_act": 2.0, "moe_combine": 1.0}
# g and beta stay f32: elementwise relative error (fast exp, softplus)
TOL_GATE_REL = 1e-4


def bf16_gap(out, ref, live=None) -> dict:
    """``out`` against ``ref`` over the positions ``live`` selects:
    ``roundings`` the largest |out - ref| / (2^-7 (|ref| + 1e-2 max|ref|)),
    ``rel_max`` max|out - ref| / max|ref|, and whether ``out`` is finite."""
    o, r = out.float(), ref.float()
    if live is not None:
        o, r = o[live], r[live]
    d = (o - r).abs()
    top = r.abs().max().clamp_min(1e-30)
    return {"roundings": float((d / (2.0 ** -7 * (r.abs() + 1e-2 * top))).max()),
            "rel_max": float(d.max() / top), "max_ref": float(top), "finite": bool(o.isfinite().all())}


def cell_lengths(rng, n: int, s: int):
    """``n`` passage lengths as the cell draws them: lognormal, median 70
    and mean ~80 tokens, cut to 16..s."""
    import numpy as np

    return np.clip(np.round(rng.lognormal(math.log(70), 0.55, n)), 16, s).astype(np.int64)


def packed_segments(rng, rows: int, s: int):
    """(rows, s) int32 segment ids: segments of 1-300 tokens, pads (0) at
    the ends of some rows."""
    import numpy as np

    seg = np.zeros((rows, s), np.int32)
    for r in range(rows):
        t, i, end = 0, 1, s - (r % 5) * 20
        while t < end:
            n = int(rng.integers(1, 300))
            seg[r, t: min(t + n, end)] = i
            t, i = t + n, i + 1
    return seg


def phase_kda(dev, smi, path_counts) -> list:
    """Phase 16: Kimi Linear's kernels against their plain versions on the
    card, their times, and the main path's launches (see the module
    docstring). Returns the kernel table's entries: kda_chunk, kda_conv,
    kda_gate, kda_out, moe_gather, moe_act, moe_combine."""
    import numpy as np
    import torch

    from codemix_dense_retrieval_torch.ops import grouped_mm as gm
    from codemix_dense_retrieval_torch.ops import kda, kernels

    kernels.reset_launch_counts()
    errs = {}

    def compare(tag, b, s, h, seed, lengths=None, seg=None):
        q, k, v, g, beta = kda_operands(b, s, h, seed, dev)
        o1 = kda.kda_chunk(q, k, v, g, beta, lengths=lengths, segment_ids=seg)
        o0 = kda.kda_chunk_plain(q, k, v, g, beta, lengths=lengths, segment_ids=seg)
        torch.cuda.synchronize()
        diff = (o1.float() - o0.float())
        rel = float(diff.norm() / o0.float().norm().clamp_min(1e-30))
        errs[tag] = {"rel_fro": rel, "max_abs": float(diff.abs().max()), "max_ref": float(o0.float().abs().max()),
                     "finite": bool(torch.isfinite(o1.float()).all())}
        del q, k, v, g, beta, o0, o1
        torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 160)
    for seed in KDA_SEEDS:
        # the cell's forward at its longest bucket: 256 rows x 512, lengths 16-512
        lens = cell_lengths(rng, 256, 512)
        lens[:8] = (1, 63, 64, 65, 128, 200, 511, 512)
        compare(f"padded_256x512_s{seed}", 256, 512, 32, seed, lengths=torch.as_tensor(lens, device=dev))
        seg = torch.as_tensor(packed_segments(rng, 32, 512), device=dev)
        compare(f"packed_32x512_s{seed}", 32, 512, 32, seed, seg=seg)
        compare(f"short_5x70_s{seed}", 5, 70, 3, seed, lengths=torch.tensor([1, 63, 64, 65, 70], device=dev))
    say("kda_chunk_check", smi=smi, tol_rel=TOL_KDA_REL, **errs)
    for tag, e in errs.items():
        check(e["finite"] and e["rel_fro"] <= TOL_KDA_REL, f"kda_chunk {tag}: {e}")

    # the block's elementwise kernels (kda_ops.cu) on the operands of the
    # cell's 256 x 512 forward (its lengths) and of 64 packed rows of 512
    gen = torch.Generator(device=dev).manual_seed(KDA_SEEDS[1])
    b, s_, h = 256, 512, 32
    c = h * 128
    lt = torch.as_tensor(cell_lengths(rng, b, s_), device=dev)
    live_pad = torch.arange(s_, device=dev)[None] < lt[:, None]
    segs = torch.as_tensor(packed_segments(rng, 64, s_), device=dev)
    x = (torch.randn(b, s_, c, generator=gen, device=dev) * 0.5).bfloat16()
    wconv = (torch.randn(c, 1, 4, generator=gen, device=dev) * 0.5).bfloat16()
    ops = {}
    for tag, xr, rows_kw, live in (("padded", x, dict(lengths=lt), live_pad),
                                   ("packed", x[:64].contiguous(), dict(segment_ids=segs), segs > 0)):
        # v, k and q as KdaAttention calls it
        for norm, scale in ((False, 1.0), (True, 1.0), (True, 128 ** -0.5)):
            y1 = kda.short_conv(xr, wconv, h, **rows_kw, normalize=norm, scale=scale)
            y0 = kda.short_conv_plain(xr, wconv, h, **rows_kw, normalize=norm, scale=scale)
            ops[f"conv_{tag}_norm{int(norm)}_scale{scale:.4g}"] = bf16_gap(y1, y0, live)
            del y1, y0
    fr = (torch.randn(b, s_, c, generator=gen, device=dev) * 3).bfloat16()
    fr[:, :, :8] = 25.0  # softplus' linear branch
    br = (torch.randn(b, s_, h, generator=gen, device=dev) * 2).bfloat16()
    al = torch.log(torch.linspace(1, 16, h, device=dev)).bfloat16()
    # softplus(dt_bias) log-uniform in [1e-3, 1e-1], as the cell draws it
    dt = torch.log(torch.expm1(10 ** (-3 + 2 * torch.rand(c, generator=gen, device=dev)))).bfloat16()
    g1, be1 = kda.decay_gate(fr, br, al, dt)
    g0, be0 = kda.decay_gate_plain(fr, br, al, dt)
    ops["gate_rel"] = float(((g1 - g0).abs() / g0.abs().clamp_min(1e-30))[live_pad].max())
    ops["beta_rel"] = float(((be1 - be0).abs() / be0.abs().clamp_min(1e-30))[live_pad].max())
    ops["gate_finite"] = bool(g1.isfinite().all() and be1.isfinite().all())
    del g1, g0, be1, be0
    o = torch.randn(b, s_, h, 128, generator=gen, device=dev).bfloat16()
    ow = (1 + 0.1 * torch.randn(128, generator=gen, device=dev)).bfloat16()
    n1 = kda.gated_rms_norm(o, fr, ow, 1e-5)
    n0 = kda.gated_rms_norm_plain(o, fr, ow, 1e-5)
    ops["out"] = bf16_gap(n1, n0, live_pad)
    del n1, n0
    say("kda_ops_check", smi=smi, tol_roundings=TOL_ROUNDINGS, tol_gate_rel=TOL_GATE_REL, **ops)
    bad = [k_ for k_, e in ops.items() if isinstance(e, dict) and not (
        e["finite"] and e["roundings"] <= TOL_ROUNDINGS["kda_out" if k_ == "out" else "kda_conv"])]
    check(not bad and ops["gate_finite"] and ops["gate_rel"] <= TOL_GATE_REL and ops["beta_rel"] <= TOL_GATE_REL,
          f"kda_ops kernels differ from their plain versions: {bad} {ops}")

    # the row moves of a MoE layer of the cell's 256-passage forward (each
    # token's 8 of 256 experts, 32 held), against their plain versions (the
    # count read on the host); rows past the count are NaN and must never be
    # read
    n_tok = int(cell_lengths(rng, 256, 512).sum())
    kk, held, hid, f = 8, 32, 2304, 1024
    chosen = torch.rand(n_tok, 256, generator=gen, device=dev).topk(kk, dim=1).indices
    keys = chosen.reshape(-1)
    keys = torch.where(keys < held, keys, held)
    ids, order = torch.sort(keys, stable=True)
    offsets = torch.searchsorted(ids, torch.arange(held, device=dev), right=True).to(torch.int32)
    cnt = offsets[-1:]
    live = int(cnt)
    xm = torch.randn(n_tok, hid, generator=gen, device=dev).bfloat16()
    src = order // kk
    xs, xs0 = gm.gather_rows(xm, src, cnt), gm.gather_rows_plain(xm, src, cnt)
    gu = torch.randn(n_tok * kk, 2 * f, generator=gen, device=dev).bfloat16()
    gu[live:] = float("nan")
    act, act0 = gm.silu_mul_rows(gu, cnt), gm.silu_mul_rows_plain(gu, cnt)
    w = torch.rand(n_tok, kk, generator=gen, device=dev)
    w = w / w.sum(dim=1, keepdim=True) * 2.446
    inv = torch.empty_like(order).index_copy_(0, order, torch.arange(n_tok * kk, device=dev)).to(torch.int32)
    ys = torch.randn(n_tok * kk, hid, generator=gen, device=dev).bfloat16()
    ys[live:] = float("nan")
    comb, comb0 = gm.combine_rows(ys, inv, w, cnt), gm.combine_rows_plain(ys, inv, w, cnt)
    rows = {"tokens": n_tok, "slots": n_tok * kk, "live": live,
            "gather_equal": bool(torch.equal(xs[:live], xs0[:live])),
            "act": bf16_gap(act[:live], act0[:live]), "combine": bf16_gap(comb, comb0)}
    say("moe_rows_check", smi=smi, tol_roundings=TOL_ROUNDINGS, **rows)
    check(rows["gather_equal"] and rows["act"]["finite"] and rows["combine"]["finite"]
          and rows["act"]["roundings"] <= TOL_ROUNDINGS["moe_act"]
          and rows["combine"]["roundings"] <= TOL_ROUNDINGS["moe_combine"],
          f"moe_rows kernels differ from their plain versions: {rows}")
    del xs0, act0, comb0
    expect = {"kda_chunk": 3 * len(KDA_SEEDS), "kda_conv": 6, "kda_gate": 1, "kda_out": 1, "moe_gather": 1,
              "moe_act": 1, "moe_combine": 1}
    got = {k_: kernels.LAUNCHES[k_] for k_ in expect}
    check(got == expect, f"the comparisons launched {got}, not {expect}")
    path_counts["bits.kda"] = dict(kernels.LAUNCHES)

    # times at the cell's shapes: each kernel, its plain version, its bound
    def timed(name, source, fn, plain, nbytes, shape):
        ms = kernel_ms(fn, 20)
        b_ms, b_by = bound(nbytes, 0)
        return dict(name=name, route="cuda", source=f"codemix_dense_retrieval_torch/csrc/{source}",
                    replaces="none (the JAX package runs neither linear attention nor expert layers)",
                    launches=0, **ms, plain_ms=cuda_ms(plain, 3), bound_ms=b_ms, bound_by=b_by,
                    roofline_pct=100.0 * b_ms / ms["ms"], shape=shape)

    tok = b * s_
    fwd = f"B=256 S=512 H=32 d=128 ({int(lt.sum())} live tokens)"
    entries = {}
    entries["kda_conv"] = timed(
        "kda_conv", "kda_ops.cu", lambda: kda.short_conv(x, wconv, h, lengths=lt, normalize=True),
        lambda: kda.short_conv_plain(x, wconv, h, lengths=lt, normalize=True),
        2 * tok * c * 2 + c * 4 * 2 + b * 4, fwd + ", q/k (L2 norm)")
    entries["kda_gate"] = timed(
        "kda_gate", "kda_ops.cu", lambda: kda.decay_gate(fr, br, al, dt),
        lambda: kda.decay_gate_plain(fr, br, al, dt),
        tok * c * (2 + 4) + tok * h * (2 + 4) + c * 2 + h * 2, fwd)
    entries["kda_out"] = timed(
        "kda_out", "kda_ops.cu", lambda: kda.gated_rms_norm(o, fr, ow, 1e-5),
        lambda: kda.gated_rms_norm_plain(o, fr, ow, 1e-5), 3 * tok * c * 2 + 128 * 2, fwd)
    del x, fr, br, o
    torch.cuda.empty_cache()
    moe = f"{n_tok} tokens x 8 of 256 experts, 32 held: {live} of {n_tok * kk} slots live"
    entries["moe_gather"] = timed(
        "moe_gather", "moe_rows.cu", lambda: gm.gather_rows(xm, src, cnt),
        lambda: gm.gather_rows_plain(xm, src, cnt), live * (hid * 2 * 2 + 8) + 4, moe + f", H={hid}")
    entries["moe_act"] = timed(
        "moe_act", "moe_rows.cu", lambda: gm.silu_mul_rows(gu, cnt),
        lambda: gm.silu_mul_rows_plain(gu, cnt), live * (2 * f * 2 + f * 2) + 4, moe + f", F={f}")
    entries["moe_combine"] = timed(
        "moe_combine", "moe_rows.cu", lambda: gm.combine_rows(ys, inv, w, cnt),
        lambda: gm.combine_rows_plain(ys, inv, w, cnt),
        live * hid * 2 + n_tok * hid * 2 + n_tok * kk * 8 + 4, moe + f", H={hid}")
    del xm, xs, gu, act, ys, comb, inv, w, order, src
    torch.cuda.empty_cache()

    # the scan at the cell's longest bucket and at its median one
    times = {}
    for s in (512, 128):
        lens = cell_lengths(rng, 256, s)
        q, k, v, g, beta = kda_operands(256, s, 32, KDA_SEEDS[0], dev)
        lt = torch.as_tensor(lens, device=dev)
        ms = kernel_ms(lambda: kda.kda_chunk(q, k, v, g, beta, lengths=lt), 5)
        plain = cuda_ms(lambda: kda.kda_chunk_plain(q, k, v, g, beta, lengths=lt), 2)
        nbytes, flops = kda_counts(lens.tolist())
        b_ms, b_by = bound(nbytes, flops, TF32_FLOPS)
        times[f"S{s}"] = dict(ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, tokens=int(lens.sum()),
                              roofline_pct=100.0 * b_ms / ms["ms"])
        del q, k, v, g, beta
        torch.cuda.empty_cache()
    entries = {"kda_chunk": dict(
        name="kda_chunk", route="cuda", source="codemix_dense_retrieval_torch/csrc/kda_chunk.cu",
        replaces="none (Kimi Delta Attention's chunked scan; the JAX package has no linear attention)",
        launches=0, **times["S512"], shape="B=256 S=512 H=32 d=128, lengths 16-512 (lognormal, median 70)",
    ), **entries}
    say("kda_times", smi=smi, kda_chunk=times,
        **{k_: {n_: e[n_] for n_ in ("ms", "ms_min", "ms_max", "plain_ms", "bound_ms", "roofline_pct")}
           for k_, e in entries.items() if k_ != "kda_chunk"})

    # the main path: TextEncoder + encode_corpus over a 4-layer Kimi Linear
    # at the published widths (3 KDA, 1 NoPE MLA; 8 of 64 experts held),
    # right-padded and packed: each of the seven kernels launched
    from codemix_dense_retrieval_torch.models.encoder import TextEncoder
    from codemix_dense_retrieval_torch.models.kimi_linear import KimiLinearConfig, KimiLinearEncoder
    from codemix_dense_retrieval_torch.pipeline.corpus import encode_corpus

    cfg = KimiLinearConfig(vocab_size=32_000, num_layers=4, full_attn_layers=(4,), n_routed_experts=64,
                           experts_held=(8, 16), dtype=torch.bfloat16)
    with torch.device("meta"):
        module = KimiLinearEncoder(cfg)
    enc = TextEncoder("moonshotai/Kimi-Linear-48B-A3B-Instruct", cfg, model=module, seed=KDA_SEEDS[0], device=dev)
    words = [f"w{i}" for i in range(500)]
    doc_lens = cell_lengths(rng, 512, 512)
    docs = [(f"d{i}", " ".join(words[(7 * i + j) % 500] for j in range(int(doc_lens[i])))) for i in range(512)]
    launched = {}
    for pack in (False, True):
        kernels.reset_launch_counts()
        out = encode_corpus(enc, {"xx": iter(docs)}, REPO / "build" / "chip_smoke_kda" / f"pack{int(pack)}",
                            batch_size=256, enc_batch=64, pack=pack, force=True)
        tag = f"pack{int(pack)}"
        launched[tag] = {k_: kernels.LAUNCHES[k_] for k_ in expect}
        path_counts[f"encode_corpus.{tag}"] = dict(kernels.LAUNCHES)
        check(all(v > 0 for v in launched[tag].values()),
              f"encode_corpus (pack={pack}) left a kernel off its path: {launched[tag]}")
        check((out["xx"] / "manifest.json").exists(), f"encode_corpus (pack={pack}) wrote no store")
    a = enc.encode_documents([t for _, t in docs[:64]], batch_size=64)
    b_ = enc.encode_documents([t for _, t in docs[:64]], batch_size=64, pack=True)
    cos = (torch.as_tensor(a) * torch.as_tensor(b_)).sum(1)
    say("kda_main_path", smi=smi, launches=launched,
        packed_vs_padded_cos_min=float(cos.min()), packed_vs_padded_cos_median=float(cos.median()))
    # bf16 forwards of other batch shapes may flip a token's expert set, so
    # the median is held and the least reported
    check(float(cos.median()) >= 0.99, f"packed and padded Kimi Linear embeddings differ: median cos {cos.median()}")
    del enc, module
    shutil.rmtree(REPO / "build" / "chip_smoke_kda", ignore_errors=True)
    torch.cuda.empty_cache()
    return list(entries.values())


# the phases that run alone: flag -> (the sources they build, the sources
# whose kernels ptxas gates, the phase, the launch counts of an entry where
# they are not its name's)
ALONE = {
    "--cover-rescore": (("bin_scores", "bin_scores_f16", "cover_rescore"), ("cover_rescore",),
                        phase_cover_rescore, {"cover_rescore": ("cover_rescore", "cover_rescore_f16")}),
    "--super-select": (("super_select", "bin_scores", "cover_rescore"), ("super_select",),
                       phase_super_select, {}),
    "--kda": (("kda_chunk", "kda_ops", "moe_rows"), ("kda_chunk", "kda_ops", "moe_rows"), phase_kda, {}),
}


def main_alone(flag: str) -> None:
    """``chip_smoke.py --cover-rescore`` (phase 14), ``--super-select``
    (phase 15) or ``--kda`` (phase 16): phase 1's card line, the build of
    the sources the phase runs (ptxas's gate on its own sources' kernels:
    none spills or serialises wgmma), then the phase alone, and its kernel
    table entries. An entry's launches are those of the phase's main-path
    runs, or of its comparisons where it runs no main path (14, 15)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; no result")
    sys.path.insert(0, str(REPO))
    from codemix_dense_retrieval_torch.ops import kernels

    names, gated, phase, counted = ALONE[flag]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build_s = kernels.build_kernels(names)
    reports = {}
    for source in gated:
        rep = kernels.ptxas_report(kernels.build_log(source))
        check(not rep["serialized"], f"ptxas serialised wgmma in {rep['serialized']}")
        check(all(v["spill_bytes"] == 0 for v in rep["kernels"].values()), f"{source} spills: {rep['kernels']}")
        reports[f"{source}_ptxas"] = rep
    say("build", seconds=round(build_s, 2), sources=names, **reports)
    path_counts = {}
    found = phase(torch.device("cuda", 0), smi, path_counts)
    entries = found if isinstance(found, list) else [found]
    main_path = {k: v for k, v in path_counts.items() if not k.startswith("bits.")} or path_counts
    for e in entries:
        e["launches"] = sum(c[name] for c in main_path.values() for name in counted.get(e["name"], (e["name"],)))
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    say("done", seconds=round(time.perf_counter() - t0, 1))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; no result")
    sys.path.insert(0, str(REPO))
    import numpy as np

    from codemix_dense_retrieval_torch.index.flat import ADAPTIVE_ROUTE_MARGIN, DenseFlatIndex
    from codemix_dense_retrieval_torch.ops import kernels
    from codemix_dense_retrieval_torch.ops import flash_attention as fa
    from codemix_dense_retrieval_torch.ops import topk
    from codemix_dense_retrieval_torch.ops.quant import int8_ip_scores, quantize_rows

    work = REPO / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    dev = torch.device("cuda", 0)
    t_main = time.perf_counter()
    walls = {}  # seconds since the start at which each phase began (the phase_walls line)

    def mark(phase: str) -> None:
        walls[phase] = round(time.perf_counter() - t_main, 1)

    # ---------------- phase 1: card ----------------
    mark("1")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    say("card", name=torch.cuda.get_device_name(0), smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())

    # ---------------- phase 2: build ----------------
    mark("2")
    build_s = kernels.build_kernels()
    # ptxas's report per source, grouped by kernel (template instances
    # summed): no wgmma kernel may be serialised (C7518) or spill
    ptxas = {}
    for name, source in kernels.SOURCES.items():
        rep = kernels.ptxas_report(kernels.build_log(name))
        fams = {}
        for mangled, v in rep["kernels"].items():
            fam = next((f for f in KERNEL_NAMES if f in mangled), mangled)
            e = fams.setdefault(fam, {"instances": 0, "max_registers": 0, "spill_bytes": 0})
            e["instances"] += 1
            e["max_registers"] = max(e["max_registers"], v["registers"])
            e["spill_bytes"] += v["spill_bytes"]
        ptxas[source] = {"warnings": rep["warnings"], "kernels": fams}
        check(not rep["serialized"], f"ptxas serialised wgmma in {rep['serialized']}")
        for fam in NO_SPILL_KERNELS & fams.keys():
            check(fams[fam]["spill_bytes"] == 0, f"{fam} spills {fams[fam]['spill_bytes']} bytes")
    # every f32 instance is bin_scores_f32_kernel's, under the gate above: A
    # (8: NT x G x score dtype), 5 and 7 (4 each) and 2 (8, the transposed
    # epilogue); none of the transposed template
    f32_fams = ptxas[kernels.SOURCES["bin_scores_f32"]]["kernels"]
    check("bin_scores_t_kernel" not in f32_fams and f32_fams["bin_scores_f32_kernel"]["instances"] == 24,
          f"bin_scores_f32.cu instances: {f32_fams}")
    from codemix_dense_retrieval_torch.io import _fastio, trec

    t0 = time.perf_counter()
    check(_fastio.available(), "the native TREC writer (csrc/fastio.cpp) did not build or load")
    fastio_s = time.perf_counter() - t0
    trec.WRITES.update(native=0, python=0, table=0)
    say("build", seconds=round(build_s, 2), sources=list(kernels.SOURCES.values()), ptxas=ptxas,
        fastio_seconds=round(fastio_s, 2), fastio=_fastio.library_path().name)

    # ---------------- phase 3: kernels vs plain ----------------
    mark("3")
    g = torch.Generator(device=dev).manual_seed(SEED)

    def unit(n, d=DIM):
        x = torch.randn(n, d, device=dev, generator=g)
        return x / x.norm(dim=1, keepdim=True)

    errs = {"bin_major": 0.0, "transposed": 0.0, "int8_bin_major": 0.0, "int8_transposed": 0.0,
            "binmax_only": 0.0, "flash_f32": 0.0, "flash_bf16": 0.0}
    def check_a(q, docs, nv, n_valid, bin_size, layout, sdt, label):
        """Kernel A or 2 against its plain version: pad scores and pad bins
        exactly NEG_INF, f32 scores within 1e-4, bf16 within one ulp."""
        s, bm = topk.bin_scores(q, docs, nv, bin_size, layout=layout, score_dtype=sdt)
        s2, bm2 = topk.bin_scores_plain(q, docs, nv, bin_size, layout=layout, score_dtype=sdt)
        torch.cuda.synchronize()
        if layout == "transposed":
            s, s2, bm, bm2 = s.T, s2.T, bm.T, bm2.T
        pad_val = torch.tensor(topk.NEG_INF).to(sdt).item()
        check(bool((s[:, n_valid:] == pad_val).all()), f"A pad {label}")
        a, r = s[:, :n_valid].float(), s2[:, :n_valid].float()
        diff = (a - r).abs()
        if sdt == torch.float32:
            check(diff.max().item() <= 1e-4, f"A f32 err {diff.max().item()} {label}")
            errs[layout] = max(errs[layout], diff.max().item())
        else:
            # one bf16 ulp of the larger value, plus the f32 accumulation-order
            # difference the rounding inherits
            ulp = torch.maximum(a.abs(), r.abs()) * 2.0 ** -7 + 1e-6
            check(bool((diff <= ulp).all()), f"A bf16 scores beyond one ulp {label}")
        bdiff = (bm.float() - bm2.float()).abs().max().item()
        check(bdiff <= 1e-4, f"A binmax err {bdiff} {label}")
        check(bool((bm[:, -(-n_valid // bin_size):] == topk.NEG_INF).all()), f"A binmax pad {label}")
        errs[layout] = max(errs[layout], bdiff)

    n = 262_144 + 123
    n_valid = n - 77
    n_pad = -(-n // 16) * 16
    docs = torch.zeros(n_pad, DIM, dtype=torch.bfloat16, device=dev)
    docs[:n] = unit(n).to(torch.bfloat16)
    # b = 64, 100 and 130 take kernel 2's n64 and n128 query tiles and
    # straddle 128; n_valid is a device int for 7, 130 and 256. Kernel A also
    # at 65, 128, 129 and 257 (two 256-query tiles)
    for b in (1, 7, 64, 65, 100, 128, 129, 130, 256, 257):
        q = unit(b).to(torch.bfloat16)
        nv = torch.tensor([n_valid], dtype=torch.int32, device=dev) if b in (7, 130, 256) else n_valid
        layouts = topk.LAYOUTS if b in (1, 7, 64, 100, 130, 256) else ("bin_major",)
        for bin_size in (8, 16):
            for layout in layouts:
                for sdt in (torch.float32, torch.bfloat16):
                    check_a(q, docs, nv, n_valid, bin_size, layout, sdt, f"b={b} G={bin_size} {layout} {sdt}")
    # kernel A's tile edges: whole 128-row tiles past n_valid = 1000, and
    # d = 96 (a half 64-dim chunk, Q resident in shared memory)
    docs96 = unit(65_536, 96).to(torch.bfloat16)
    for b in (1, 7, 64, 65, 100, 128, 129, 130, 256, 257):
        q, q96 = unit(b).to(torch.bfloat16), unit(b, 96).to(torch.bfloat16)
        for bin_size in (8, 16):
            sdt = torch.float32 if b % 2 else torch.bfloat16
            check_a(q, docs, 1000, 1000, bin_size, "bin_major", sdt, f"nv=1000 b={b} G={bin_size} {sdt}")
            check_a(q96, docs96, 65_536 - 40, 65_536 - 40, bin_size, "bin_major", sdt,
                    f"d=96 b={b} G={bin_size} {sdt}")

    def check_4(q8, qs8, d8, ds8, nv, n_valid, bin_size, layout, sdt, label):
        """Kernel 4 against its plain version: torch.equal, pad scores and
        pad bins exactly NEG_INF."""
        s, bm = topk.bin_scores_int8(q8, qs8, d8, ds8, nv, bin_size, layout=layout, score_dtype=sdt)
        s2, bm2 = topk.bin_scores_int8_plain(q8, qs8, d8, ds8, nv, bin_size, layout=layout, score_dtype=sdt)
        torch.cuda.synchronize()
        check(torch.equal(s, s2) and torch.equal(bm, bm2), f"kernel 4 not bit-equal to its plain version {label}")
        if layout == "transposed":
            s, bm = s.T, bm.T
        pad_val = torch.tensor(topk.NEG_INF).to(sdt).item()
        check(bool((s[:, n_valid:] == pad_val).all()), f"4 pad {label}")
        check(bool((bm[:, -(-n_valid // bin_size):] == topk.NEG_INF).all()), f"4 binmax pad {label}")

    def check_5(q, docs, nv, n_valid, bin_size, label):
        """Kernel 5 against its plain version: within 1e-4, pad bins exactly
        NEG_INF."""
        bm = topk.binmax_only(q, docs, nv, bin_size)
        bm2 = topk.binmax_only_plain(q, docs, nv, bin_size)
        torch.cuda.synchronize()
        err5 = (bm - bm2).abs().max().item()
        check(err5 <= 1e-4, f"5 binmax err {err5} {label}")
        check(bool((bm[:, -(-n_valid // bin_size):] == topk.NEG_INF).all()), f"5 binmax pad {label}")
        errs["binmax_only"] = max(errs["binmax_only"], err5)

    # kernel 4 on the same rows quantized (zero pad rows: scale 1, values 0)
    # and kernel 5 on the bf16 rows, at kernel A's query counts (n_valid a
    # device int for 7, 130 and 256); then whole tiles past n_valid = 1000,
    # and kernel 4 at d = 192 (one and a half 128-byte stages), kernel 5 at
    # d = 96 (one and a half 64-dim chunks)
    d8, ds8 = quantize_rows(docs)
    d8_192, ds8_192 = quantize_rows(unit(65_536, 192))
    for b in (1, 7, 64, 65, 100, 128, 129, 130, 256, 257):
        qf, qf192 = unit(b), unit(b, 192)
        q8, qs8 = quantize_rows(qf)
        q8_192, qs8_192 = quantize_rows(qf192)
        qb, q96 = qf.to(torch.bfloat16), unit(b, 96).to(torch.bfloat16)
        nv = torch.tensor([n_valid], dtype=torch.int32, device=dev) if b in (7, 130, 256) else n_valid
        for bin_size in (8, 16):
            for layout in topk.LAYOUTS:
                for sdt in (torch.float32, torch.bfloat16):
                    check_4(q8, qs8, d8, ds8, nv, n_valid, bin_size, layout, sdt,
                            f"b={b} G={bin_size} {layout} {sdt}")
                sdt = torch.float32 if b % 2 else torch.bfloat16
                check_4(q8, qs8, d8, ds8, 1000, 1000, bin_size, layout, sdt,
                        f"nv=1000 b={b} G={bin_size} {layout} {sdt}")
                check_4(q8_192, qs8_192, d8_192, ds8_192, 65_536 - 40, 65_536 - 40, bin_size, layout, sdt,
                        f"d=192 b={b} G={bin_size} {layout} {sdt}")
            check_5(qb, docs, nv, n_valid, bin_size, f"b={b} G={bin_size}")
            check_5(qb, docs, 1000, 1000, bin_size, f"nv=1000 b={b} G={bin_size}")
            check_5(q96, docs96, 65_536 - 40, 65_536 - 40, bin_size, f"d=96 b={b} G={bin_size}")
    del docs, docs96, d8, ds8, d8_192, ds8_192

    for seq in (1024, 2048):
        for dh in (64, 128):
            for dt in (torch.float32, torch.bfloat16):
                for causal, kvh, with_seg in ((False, 16, False), (True, 4, True)):
                    bsz, h = 4, 16
                    q = torch.randn(bsz, seq, h, dh, device=dev, generator=g).to(dt).transpose(1, 2)
                    k = torch.randn(bsz, seq, kvh, dh, device=dev, generator=g).to(dt).transpose(1, 2)
                    v = torch.randn(bsz, seq, kvh, dh, device=dev, generator=g).to(dt).transpose(1, 2)
                    lens = [seq, seq - 100, 0, 700] if not causal else [seq, 0, seq - 1, 900]
                    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                    seg = None
                    if with_seg:
                        seg = torch.zeros(bsz, seq, dtype=torch.int32, device=dev)
                        for i, ln in enumerate(lens):
                            seg[i, :ln] = torch.arange(ln, device=dev, dtype=torch.int32) // 300 + 1
                    o = fa.attention_flash(q, k, v, lengths, causal=causal, segment_ids=seg)
                    o2 = fa.attention_flash_plain(q.float(), k.float(), v.float(), lengths,
                                                  causal=causal, segment_ids=seg)
                    torch.cuda.synchronize()
                    err = (o.float() - o2).abs().max().item()
                    tol = 1e-4 if dt == torch.float32 else 2e-2
                    check(err <= tol, f"B err {err} S={seq} dh={dh} {dt} causal={causal}")
                    check(bool((o[2 if not causal else 1] == 0).all()), "B zero-length rows not 0")
                    if seg is not None:
                        dead = (seg == 0)[:, None, :, None].expand_as(o)
                        check(bool((o[dead] == 0).all()), "B pad-segment rows not 0")
                    key = "flash_f32" if dt == torch.float32 else "flash_bf16"
                    errs[key] = max(errs[key], err)
    # kernel B at its tile edges: lengths around the 128-key tile and a
    # sequence length that is not a multiple of the 128-query tile
    for seq in (1000, 1024):
        for dh in (64, 128):
            for causal, kvh, with_seg in ((False, 16, False), (True, 4, True)):
                lens = [0, 1, 127, 128, 129, seq]
                bsz, h = len(lens), 16
                q = torch.randn(bsz, seq, h, dh, device=dev, generator=g).to(torch.bfloat16).transpose(1, 2)
                k = torch.randn(bsz, seq, kvh, dh, device=dev, generator=g).to(torch.bfloat16).transpose(1, 2)
                v = torch.randn(bsz, seq, kvh, dh, device=dev, generator=g).to(torch.bfloat16).transpose(1, 2)
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                seg = None
                if with_seg:
                    seg = torch.zeros(bsz, seq, dtype=torch.int32, device=dev)
                    for i, ln in enumerate(lens):
                        seg[i, :ln] = torch.arange(ln, device=dev, dtype=torch.int32) // 300 + 1
                o = fa.attention_flash(q, k, v, lengths, causal=causal, segment_ids=seg)
                o2 = fa.attention_flash_plain(q.float(), k.float(), v.float(), lengths,
                                              causal=causal, segment_ids=seg)
                torch.cuda.synchronize()
                err = (o.float() - o2).abs().max().item()
                check(err <= 2e-2, f"B err {err} S={seq} dh={dh} lengths={lens} causal={causal}")
                check(bool((o[0] == 0).all()), "B zero-length rows not 0 at the tile edges")
                if seg is not None:
                    dead = (seg == 0)[:, None, :, None].expand_as(o)
                    check(bool((o[dead] == 0).all()), "B pad-segment rows not 0 at the tile edges")
                errs["flash_bf16"] = max(errs["flash_bf16"], err)
    del q, k, v, o, o2
    # the flash/plain crossover at BGE-M3's heads (H=16, dh=64), 32,768 tokens
    # per call, lengths uniform in (S/2, S] as in a length bucket (measured
    # only: FLASH_MIN_SEQ stays 512)
    crossover = {}
    for seq in (256, 512):
        bsz = 32_768 // seq
        lens = torch.randint(seq // 2 + 1, seq + 1, (bsz,), device=dev, generator=g, dtype=torch.int32)
        q, k, v = (torch.randn(bsz, seq, 16, 64, device=dev, generator=g).to(torch.bfloat16).transpose(1, 2)
                   for _ in range(3))
        crossover[f"S{seq}_B{bsz}"] = {
            "flash_ms": cuda_ms(lambda: fa.attention_flash(q, k, v, lens), 20),
            "plain_xla_ms": cuda_ms(lambda: fa.attention_xla(q, k, v, lens), 20),
        }
    del q, k, v
    say("flash_crossover", heads=16, head_dim=64, tokens_per_call=32_768, flash_min_seq=fa.FLASH_MIN_SEQ,
        **crossover)

    # kernel 7: bf16 sketches with f32 tails, ragged n_valid and whole tiles
    # past it; ds = 96 (a half 64-dim chunk), 128 (the sketch tier's) and 512
    # (at 256 queries a 256 KB query sketch: Q streams instead of staying
    # resident); 257 queries make two query tiles, so Q is loaded twice
    from codemix_dense_retrieval_torch.ops import maxsim as msim
    from codemix_dense_retrieval_torch.ops import sketch as sk

    n7 = 262_144 + 64
    d_tl = torch.rand(n7, device=dev, generator=g) * 0.3
    errs["binub"] = errs["maxsim"] = 0.0
    for ds in (96, 128, 512):
        # rows scaled so |ub| stays below 1.5 at every ds, as for a sketch of unit rows
        d_sk = (torch.randn(n7, ds, device=dev, generator=g) * (0.1 * (128 / ds) ** 0.5)).to(torch.bfloat16)
        for b in (1, 7, 256, 257):
            q_sk = (torch.randn(b, ds, device=dev, generator=g) * 0.1).to(torch.bfloat16)
            q_tl = torch.rand(b, device=dev, generator=g) * 0.3
            for bin_size in (8, 16):
                for nv7 in (n7 - 77, 1000):
                    nv = torch.tensor([nv7], dtype=torch.int32, device=dev) if b == 256 else nv7
                    ub = sk.binub(q_sk, q_tl, d_sk, d_tl, bin_size, nv)
                    ub2 = sk.binub_plain(q_sk, q_tl, d_sk, d_tl, bin_size, nv)
                    torch.cuda.synchronize()
                    err7 = (ub - ub2).abs().max().item()
                    check(err7 <= TOL_BINUB, f"7 err {err7} ds={ds} b={b} G={bin_size} nv={nv7}")
                    check(bool((ub[:, -(-nv7 // bin_size):] == topk.NEG_INF).all()), "7 pad bins")
                    errs["binub"] = max(errs["binub"], err7)
    del d_sk, d_tl, ub, ub2

    # kernel 6: ragged K, Tq and Td (query groups past 32 tokens, partial doc
    # chunks), a candidate with every token masked, masked query tokens
    def unit_rows(*shape):
        x = torch.randn(*shape, device=dev, generator=g)
        return x / x.norm(dim=-1, keepdim=True)

    for b, kc, tq, td, dm in ((3, 37, 5, 7, 128), (4, 81, 32, 32, DIM), (2, 17, 40, 45, DIM),
                              (5, 200, 16, 64, 256)):
        qt = unit_rows(b, tq, dm)
        dt = unit_rows(b, kc, td, dm).to(torch.bfloat16)
        qm = (torch.rand(b, tq, device=dev, generator=g) < 0.8).to(torch.int32)
        qm[:, 0] = 1
        dmask = (torch.rand(b, kc, td, device=dev, generator=g) < 0.8).to(torch.int32)
        dmask[:, :, 0] = 1
        dmask[0, 2] = 0
        qm[1, 1:] = 0
        s6 = msim.maxsim_scores(qt, qm, dt, dmask)
        s6p = msim.maxsim_scores_plain(qt, qm, dt, dmask)
        torch.cuda.synchronize()
        err6 = (s6 - s6p).abs().max().item()
        check(bool(((s6 - s6p).abs() <= TOL_MAXSIM + TOL_MAXSIM_REL * s6p.abs()).all()),
              f"6 err {err6} at {(b, kc, tq, td, dm)}")
        check(s6[0, 2].item() == 0.0, "6: a candidate with no valid token must score 0")
        errs["maxsim"] = max(errs["maxsim"], err6)
    del qt, dt, s6, s6p

    # the sketch tier with ds = d: every query certified, the exact ids
    xs = unit_rows(65_536, 128).to(torch.bfloat16).cpu()
    sk_ix = DenseFlatIndex.build(xs, [str(i) for i in range(65_536)]).to_device()
    sk_ix.enable_sketch(sketch_dim=128, probe_bins=64, cache=False)
    qs = unit_rows(64, 128)
    _, sk_ids = sk_ix.search(qs, 10, return_docids=False, approx=True)
    full_cert = int(sk_ix.last_certified.sum())
    _, ex_ids = sk_ix.search(qs, 10, return_docids=False)
    check(full_cert == 64, f"ds = d sketch certified {full_cert} of 64 queries")
    check(bool((sk_ids == ex_ids).all()), "ds = d sketch ids differ from exact search")
    del sk_ix, xs
    say("kernels_vs_plain", max_abs_err=errs, sketch_ds_eq_d_certified=f"{full_cert}/64",
        tolerances={"A_f32": 1e-4, "A_bf16": "1 ulp + 1e-6", "int8": 0, "binmax_only": 1e-4,
                    "B_f32": 1e-4, "B_bf16": 2e-2, "binub": TOL_BINUB,
                    "maxsim": f"{TOL_MAXSIM} + {TOL_MAXSIM_REL} |score|"})

    # ---------------- phase 4: encoder at BGE-M3 width ----------------
    mark("4")
    from codemix_dense_retrieval_torch.io.token_shards import TokenShardStore
    from codemix_dense_retrieval_torch.models import dialects
    from codemix_dense_retrieval_torch.models.encoder import TextEncoder
    from codemix_dense_retrieval_torch.models.xlmr import XLMRConfig
    from codemix_dense_retrieval_torch.ops.mix import mix_and_renorm
    from codemix_dense_retrieval_torch.pipeline.query_cache import load_query_cache

    rng = np.random.default_rng(SEED)

    def sentence(prefix, lo, hi, vocab):
        return " ".join(f"{prefix}{w}" for w in rng.integers(0, vocab, rng.integers(lo, hi + 1)))

    qids = [f"q{i}" for i in range(N_QUERIES)]
    texts_a = [sentence("en", 6, 16, 20_000) for _ in qids]
    texts_b = [sentence("zh", 4, 12, 20_000) for _ in qids]
    passages = [sentence("p", 600, 1000, 50_000) for _ in range(N_PASSAGES)]
    buckets = (16, 32, 64, 128, 256, 512, 1024)
    cfg = XLMRConfig.bge_m3(dtype=torch.bfloat16)
    path_counts = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    enc = TextEncoder("BAAI/bge-m3", cfg, seed=SEED, length_buckets=buckets)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    enc.encode_queries(texts_a[:8])
    enc.encode_documents(passages[:2], max_length=1024)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qa = enc.encode_queries(texts_a, batch_size=128)
    qb = enc.encode_queries(texts_b, batch_size=128)
    q_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pv = enc.encode_documents(passages, batch_size=32, max_length=1024, readback_dtype=torch.bfloat16)
    p_s = time.perf_counter() - t0
    stats_1024 = dict(enc.last_phase_stats)
    path_counts["encode"] = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    enc.tokenizer.encode_batch(passages, 1024)
    tok_s = time.perf_counter() - t0
    check(path_counts["encode"]["flash_attention"] > 0, "encoder passages did not launch kernel B")
    for name, x, rows in (("qa", qa, N_QUERIES), ("qb", qb, N_QUERIES), ("passages", pv, N_PASSAGES)):
        check(x.shape == (rows, DIM) and bool(np.isfinite(x).all()), f"{name} embeddings shape/finite")
        check(bool(np.allclose(np.linalg.norm(x, axis=1), 1.0, atol=2e-2)), f"{name} not unit norm")
    # the same weights through plain attention agree with the kernel path
    plain_enc = TextEncoder("BAAI/bge-m3", XLMRConfig.bge_m3(dtype=torch.bfloat16, use_flash=False),
                            seed=SEED, length_buckets=buckets)
    pv_plain = plain_enc.encode_documents(passages[:16], batch_size=16, max_length=1024)
    pv_kernel = enc.encode_documents(passages[:16], batch_size=16, max_length=1024)
    cos = float((pv_plain * pv_kernel).sum(axis=1).min())
    check(cos >= 0.99, f"kernel-path vs plain-path passage cosine {cos}")
    # the device side alone: one tokenized batch of 32 passages at the 1024
    # bucket through the model, with kernel B and with plain attention
    ids32, mask32 = (x.to(dev) for x in next(enc._batch_inputs(passages[:32], 32, "", 1024)))
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: enc.model(ids32, mask32), 5)
        fwd_plain_ms = cuda_ms(lambda: plain_enc.model(ids32, mask32), 5)
    del plain_enc
    qa_t = torch.from_numpy(qa)
    qb_t = torch.from_numpy(qb)
    qcos = (qa_t @ qa_t.T).fill_diagonal_(0).max().item()
    say("encoder", config="BGE-M3 (24L, d=1024, 16 heads, FFN 4096, vocab 250002) random init bf16",
        init_s=round(init_s, 2), queries=2 * N_QUERIES, queries_per_s=round(2 * N_QUERIES / q_s, 1),
        passages=N_PASSAGES, passages_per_s=round(N_PASSAGES / p_s, 2),
        passage_tokens_bucket=1024, passage_tokenize_s=round(tok_s, 3), passage_encode_s=round(p_s, 3),
        launches=path_counts["encode"], forward_ms_32x1024=fwd_ms, forward_ms_32x1024_plain_attention=fwd_plain_ms,
        kernel_vs_plain_min_cos=round(cos, 5), max_offdiag_query_cos=round(qcos, 4),
        phase_stats_1024=stats_1024)

    # ---------------- phase 4b: sequence-packed encode ----------------
    mark("4b")
    from codemix_dense_retrieval_torch.io.shards import ShardStore
    from codemix_dense_retrieval_torch.io.tsv import write_queries_tsv
    from codemix_dense_retrieval_torch.models.convert import flax_from_state_dict, save_params_npz

    # mMARCO-like lengths: most passages of 20-200 words, a tenth of 300-480,
    # so the leading (longest) chunks pack into rows of 512 (kernel B)
    words_4b = rng.integers(20, 201, N_PACKED)
    long_4b = rng.random(N_PACKED) < 0.1
    words_4b[long_4b] = rng.integers(300, 481, int(long_4b.sum()))
    packed_texts = [" ".join(f"m{w}" for w in rng.integers(0, 50_000, n)) for n in words_4b]
    _, tmask_4b = enc.tokenizer.encode_batch(packed_texts, 512)
    tokens_4b = tmask_4b.sum(axis=1)
    tok_per_word = float((tokens_4b - 2).sum() / words_4b.sum())  # less the bos and eos tokens
    check(0.99 <= tok_per_word <= 1.01, f"phase 4b words make {tok_per_word} tokens each, not ~1")
    # the packing the encoder does, chunk by chunk: efficiency and row lengths
    seq_4b, rpb_4b, pad_4b = enc._packed_setup(PACK_BATCH, None)
    sorted_4b = [packed_texts[i] for i in enc._length_order(packed_texts)]
    def packing_of(row_len):
        """(valid-token share, rows per row length, the segment ids of the
        forward with the most segments) of the encoder's chunks."""
        enc._PACK_SEQ_DEFAULT = row_len
        valid = slots = 0
        by_len, seg_ids = {}, None
        for _, _, pk, _ in enc._packed_chunks(sorted_4b, dialects.doc_prefix(enc.name), seq_4b, rpb_4b, 16,
                                              pad_4b, None):
            valid += int((pk.segment_ids > 0).sum())
            slots += pk.ids.size
            by_len[pk.ids.shape[1]] = by_len.get(pk.ids.shape[1], 0) + pk.n_rows
            for r0 in range(0, pk.n_rows, rpb_4b):
                fwd = pk.segment_ids[r0 : r0 + rpb_4b]
                if pk.ids.shape[1] == 512 and (seg_ids is None or fwd.max(axis=1).sum() > seg_ids.max(axis=1).sum()):
                    seg_ids = fwd
        del enc._PACK_SEQ_DEFAULT  # back to the class constant (the JAX package's 256)
        return valid / slots, by_len, seg_ids

    eff_4b, rows_by_len, _ = packing_of(enc._PACK_SEQ_DEFAULT)
    eff_512, _, seg_512 = packing_of(512)
    check(512 in rows_by_len, f"no chunk packed into rows of 512: {rows_by_len}")

    def timed_encode(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = enc.encode_documents(packed_texts, batch_size=PACK_BATCH, **kw)
        return out, time.perf_counter() - t0, dict(enc.last_phase_stats)

    enc.encode_documents(sorted_4b[:512], batch_size=PACK_BATCH, pack=True)  # warm both paths
    enc.encode_documents(sorted_4b[:512], batch_size=PACK_BATCH)
    kernels.reset_launch_counts()
    pk_emb, pk_s, pk_stats = timed_encode(pack=True)
    path_counts["encode_packed"] = dict(kernels.LAUNCHES)
    check(path_counts["encode_packed"]["flash_attention"] > 0, "the packed encode did not launch kernel B")
    up_emb, up_s, up_stats = timed_encode()
    # every chunk at rows of 512 (an instance override for the measurement;
    # the class constant stays the JAX package's 256)
    enc._PACK_SEQ_DEFAULT = 512
    kernels.reset_launch_counts()
    pk512_emb, pk512_s, pk512_stats = timed_encode(pack=True)
    path_counts["encode_packed_512"] = dict(kernels.LAUNCHES)
    del enc._PACK_SEQ_DEFAULT
    check(path_counts["encode_packed_512"]["flash_attention"] > 0, "the rows-of-512 encode did not launch kernel B")
    agree = {}
    for name, emb in (("rows_256", pk_emb), ("rows_512", pk512_emb)):
        check(emb.shape == up_emb.shape and bool(np.isfinite(emb).all()), f"packed {name} embeddings shape/finite")
        cos_p = float((emb * up_emb).sum(axis=1).min())
        abs_p = float(np.abs(emb - up_emb).max())
        agree[name] = {"min_cos": cos_p, "max_abs": abs_p}
        check(cos_p >= 0.999 and abs_p <= TOL_PACKED_ABS,
              f"packed ({name}) vs unpacked embeddings: min cos {cos_p}, max abs {abs_p}")
    # kernel B at the packed shape: one forward's rows of 512 with their
    # segment ids, against its plain version; pad-segment rows exactly zero
    seg_b = torch.from_numpy(seg_512).to(dev)
    lens_b = (seg_b > 0).sum(dim=1, dtype=torch.int32)
    qkv_b = [torch.randn(len(seg_512), 512, 16, 64, device=dev, generator=g).to(torch.bfloat16).transpose(1, 2)
             for _ in range(3)]
    o_b = fa.attention_flash(*qkv_b, lens_b, segment_ids=seg_b)
    o_bp = fa.attention_flash_plain(*(t.float() for t in qkv_b), lens_b, segment_ids=seg_b)
    torch.cuda.synchronize()
    err_packed = (o_b.float() - o_bp).abs().max().item()
    check(err_packed <= 2e-2, f"B err {err_packed} at the packed shape")
    dead_b = (seg_b == 0)[:, None, :, None].expand_as(o_b)
    check(bool((o_b[dead_b] == 0).all()), "B pad-segment rows not 0 at the packed shape")
    same_seg = (seg_b[:, None, :, None] == seg_b[:, None, None, :]) & (seg_b > 0)[:, None, None, :]
    packed_b = dict(
        packed_shape=f"B={len(seg_512)} H=16 S=512 dh=64 bf16, {int(seg_b.max())} segments max, "
                     f"{float((seg_b > 0).float().mean()):.3f} of tokens valid",
        packed_max_abs_err=err_packed,
        packed_ms=kernel_ms(lambda: fa.attention_flash(*qkv_b, lens_b, segment_ids=seg_b), 20),
        packed_plain_ms=cuda_ms(lambda: fa.attention_flash_plain(*qkv_b, lens_b, segment_ids=seg_b), 3),
        packed_library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            *qkv_b, attn_mask=same_seg), 20),
    )
    # q, k, v read and the output written once; every query attends to its
    # own segment's keys: 4 flops per (query, key, dh) of a segment
    packed_b["packed_bound_ms"], packed_b["packed_bound_by"] = bound(
        4 * len(seg_512) * 16 * 512 * 64 * 2,
        4 * 16 * 64 * float(sum(int((r == v).sum()) ** 2 for r in seg_512 for v in np.unique(r[r > 0]))))
    del qkv_b, o_b, o_bp, same_seg
    say("encode_packed", passages=N_PACKED, words="20-200, a tenth 300-480", tokens_per_word=tok_per_word,
        mean_tokens=float(tokens_4b.mean()), batch_size=PACK_BATCH, rows_per_forward=rpb_4b,
        pack_seq_default=enc._PACK_SEQ_DEFAULT, packed_rows_by_length=rows_by_len,
        packing_efficiency={"rows_256": eff_4b, "rows_512": eff_512},
        packed_passages_per_s=round(N_PACKED / pk_s, 1), unpacked_passages_per_s=round(N_PACKED / up_s, 1),
        packed_rows512_passages_per_s=round(N_PACKED / pk512_s, 1),
        phase_stats={"packed": pk_stats, "unpacked": up_stats, "packed_rows512": pk512_stats},
        packed_vs_unpacked=agree, tolerance={"min_cos": 0.999, "max_abs": TOL_PACKED_ABS},
        kernel_b_packed=packed_b,
        launches={"packed": path_counts["encode_packed"], "packed_rows512": path_counts["encode_packed_512"]})
    del pk_emb, up_emb, pk512_emb
    # the BGE-M3-width checkpoint and the query TSVs the CLI phases read
    ckpt = work / "ckpt"
    ckpt.mkdir()
    save_params_npz(ckpt / "params.npz", flax_from_state_dict(enc.model.state_dict()))
    (ckpt / "encoder_config.json").write_text(json.dumps(cfg.to_json_dict(), indent=2))
    write_queries_tsv(work / "en.tsv", zip(qids, texts_a))
    write_queries_tsv(work / "zh.tsv", zip(qids, texts_b))

    # encode-corpus --pack through the CLI (int8 rows, a 32-token store),
    # then run-mix over its store: the exact int8 top-k
    pack_tsv = work / "corpus_pack.tsv"
    pack_tsv.write_text("".join(f"p{i}\t{t}\n" for i, t in enumerate(packed_texts)))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run_cli(["codemix_dense_retrieval_torch", "encode-corpus", "--checkpoint", str(ckpt),
             "--corpus_tsv", f"pk={pack_tsv}", "--storage_dtype", "int8", "--pack",
             "--out", str(work / "corpus_pack"), "--batch", "4096", "--enc_batch", str(PACK_BATCH),
             "--tokens_per_doc", str(TD), "--seed", str(SEED)])
    pack_cli_s = time.perf_counter() - t0
    path_counts["corpus_pack_cli"] = dict(kernels.LAUNCHES)
    check(path_counts["corpus_pack_cli"]["flash_attention"] > 0, "encode-corpus --pack did not launch kernel B")
    store_pk = ShardStore.open(work / "corpus_pack" / "pk")
    tok_pk = TokenShardStore.open(work / "corpus_pack" / "pk" / "tokens")
    check(store_pk.count == N_PACKED and store_pk.manifest.dtype == "int8" and store_pk.scales.shape == (N_PACKED,),
          "encode-corpus --pack int8 store shape / scales")
    check(tok_pk.docids == store_pk.docids and bool((tok_pk.lengths == np.minimum(tokens_4b, TD)).all()),
          "encode-corpus --pack token store alignment / lengths")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run_cli(["codemix_dense_retrieval_torch", "run-mix", "--checkpoint", str(ckpt),
             "--index", str(work / "corpus_pack" / "pk"), "--query_tsv", f"en={work / 'en.tsv'}",
             f"zh={work / 'zh.tsv'}", "--outdir", str(work / "corpus_pack_runs"), "--k", "100",
             "--qblock", "256", "--cm_alphas", "0.5", "--query_cache", str(work / "qcache_pk"),
             "--seed", str(SEED)])
    pack_run_s = time.perf_counter() - t0
    path_counts["corpus_pack_run"] = dict(kernels.LAUNCHES)
    check(path_counts["corpus_pack_run"]["bin_scores_int8_transposed"] > 0,
          "run-mix over the packed int8 store did not launch kernel 4")
    _, pva = load_query_cache(work / "qcache_pk" / "en" / "queries.npz", expected_qids=qids)
    _, pvb = load_query_cache(work / "qcache_pk" / "zh" / "queries.npz", expected_qids=qids)
    pq8, pqs8 = quantize_rows(mix_and_renorm(torch.from_numpy(pva).to(dev), torch.from_numpy(pvb).to(dev), 0.5))
    want_pk = topk._stable_topk(int8_ip_scores(pq8, pqs8, store_pk.rows().to(dev),
                                               torch.from_numpy(store_pk.scales).to(dev)), 100)[1].cpu().numpy()
    got_pk = {}
    with open(work / "corpus_pack_runs" / "cm-alpha-0.5.trec") as fh:
        for line in fh:
            qid, _, doc, _, _, _ = line.split()
            got_pk.setdefault(qid, []).append(int(doc.split("#")[0][1:]))
    check(len(got_pk) == N_QUERIES and np.array_equal(np.array([got_pk[q] for q in qids]), want_pk),
          "run-mix over the packed int8 store differs from the exact int8 top-k")
    say("corpus_pack_cli", passages=N_PACKED, storage_dtype="int8", tokens_per_doc=TD, pack=True,
        encode_corpus_s=round(pack_cli_s, 2), passages_per_s=round(N_PACKED / pack_cli_s, 1),
        run_mix_s=round(pack_run_s, 2), ids_equal_exact_int8_topk=True,
        launches={"encode_corpus": path_counts["corpus_pack_cli"], "run_mix": path_counts["corpus_pack_run"]})

    # ---------------- phase 5: vector-mix run at full size ----------------
    mark("5")
    from codemix_dense_retrieval_torch.cli import main as cli_main
    from codemix_dense_retrieval_torch.pipeline.runs import run_vector_mix_search

    mix05 = mix_and_renorm(qa_t.to(dev), qb_t.to(dev), 0.5)
    t0 = time.perf_counter()
    host = torch.empty((N_ROWS, DIM), dtype=torch.bfloat16)
    gi = torch.Generator(device=dev).manual_seed(SEED + 1)
    for c0 in range(0, N_ROWS, 1 << 20):
        c1 = min(c0 + (1 << 20), N_ROWS)
        x = torch.randn(c1 - c0, DIM, device=dev, generator=gi)
        host[c0:c1].copy_((x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16))
    # each query pair gets one relevant passage near its alpha=0.5 mix
    planted = torch.randperm(N_ROWS, generator=torch.Generator().manual_seed(SEED + 2))[:N_QUERIES]
    noise = torch.randn(N_QUERIES, DIM, device=dev, generator=gi)
    near = mix05 + 0.5 * noise / noise.norm(dim=1, keepdim=True)
    host[planted] = (near / near.norm(dim=1, keepdim=True)).to(torch.bfloat16).cpu()
    docids = [str(i) for i in range(N_ROWS)]
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = DenseFlatIndex.build(host, docids).to_device()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    check(index._rows_per_shard >= topk.TWO_LEVEL_MIN_ROWS, "index below the two-level threshold")

    out5 = work / "search"
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    runs100 = run_vector_mix_search(index, qids, qa, qb, ALPHAS, out5 / "k100", k=100, query_block=256)
    t100 = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs1000 = run_vector_mix_search(index, qids, qa, qb, [0.5], out5 / "k1000", k=1000, query_block=256)
    t1000 = time.perf_counter() - t0
    path_counts["search"] = dict(kernels.LAUNCHES)
    check(path_counts["search"]["binmax_only"] > 0 and path_counts["search"]["cover_rescore"] > 0
          and path_counts["search"]["super_select"] > 0,
          "search did not launch kernel 5, cover_rescore and super_select")
    say("search", rows=N_ROWS, rows_padded=index._rows_per_shard, dim=DIM, dtype="bfloat16",
        gen_s=round(gen_s, 2), upload_s=round(upload_s, 2),
        k100_alphas=len(ALPHAS), k100_queries_per_s=round(len(ALPHAS) * N_QUERIES / t100, 1),
        k1000_queries_per_s=round(N_QUERIES / t1000, 1), query_block=256,
        launches=path_counts["search"])

    def run_table(path, k, doc_int=int):
        """(ids (512, k), scores (512, k)) of a TREC run, in qid order."""
        rows = {}
        with open(path) as fh:
            for line in fh:
                qid, _, doc, _, score, _ = line.split()
                rows.setdefault(qid, []).append((doc_int(doc), float(score)))
        check(all(len(rows[q]) == k for q in qids), f"{path} rows per query != {k}")
        return (np.array([[d for d, _ in rows[q]] for q in qids]),
                np.array([[v for _, v in rows[q]] for q in qids]))

    def run_ids(path, k):
        return run_table(path, k)[0]

    ids100 = run_ids(runs100[0.5], 100)
    ids1000 = run_ids(runs1000[0.5], 1000)
    for a in ALPHAS:
        run_ids(runs100[a], 100)

    def oracle_topk(q32, docs_dev, n_rows, k, chunk=262_144):
        """Chunked f32 exact top-k with a running stable (score desc, id asc) merge."""
        return exact_topk(lambda c0, c1: q32 @ docs_dev[c0:c1].float().T, n_rows, k, chunk)

    def exact_topk(scores_of, n_rows, k, chunk=262_144):
        """Exact top-k of the (B, c1 - c0) scores ``scores_of(c0, c1)`` with
        a running stable (score desc, id asc) merge."""
        vals = ids = None
        for c0 in range(0, n_rows, chunk):
            c1 = min(c0 + chunk, n_rows)
            s = scores_of(c0, c1)
            if vals is None:
                vals = s[:, :0]
                ids = torch.empty((s.shape[0], 0), dtype=torch.long, device=dev)
            v = torch.cat([vals, s], dim=1)
            i = torch.cat([ids, torch.arange(c0, c1, device=dev).expand(s.shape[0], -1)], dim=1)
            sv, order = torch.sort(v, dim=1, descending=True, stable=True)
            vals, ids = sv[:, :k], torch.gather(i, 1, order[:, :k])
        return vals, ids

    def overlap(a, b):
        return float(np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)]))

    q05 = mix05.to(torch.bfloat16)
    t0 = time.perf_counter()
    ovals, oids = oracle_topk(q05.float(), index._docs_dev[0], N_ROWS, 1000)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    oids = oids.cpu().numpy()
    ov = ovals.cpu().numpy()
    gap = float((ov[:, 0] - ov[:, 1]).min())
    ov100, ov1000 = overlap(ids100, oids[:, :100]), overlap(ids1000, oids)
    check(ov100 >= 0.999 and ov1000 >= 0.999, f"oracle overlap {ov100} / {ov1000}")
    qrels = work / "qrels.tsv"
    qrels.write_text("".join(f"{q}\t{oids[i, 0]}\t1\n" for i, q in enumerate(qids)))
    cli_main(["evaluate", "--dataset", "smoke", "--run", str(runs100[0.5]), "--qrels", str(qrels),
              "--outdir", str(work / "eval"), "--metrics", "MRR@10", "nDCG@10", "R@100"])
    (agg_path,) = (work / "eval").glob("*-agg.json")
    agg = json.loads(agg_path.read_text())
    check(agg["RR@10"] == 100.0, f"RR@10 {agg['RR@10']}")
    # the run equals a stable (score desc, id asc) top-k of the kernel's own scores
    s64, _ = topk.bin_scores(q05[:64].contiguous(), index._docs_dev[0], index._counts_dev[0], 8,
                             layout="bin_major")
    thr = torch.topk(s64, 1000, dim=1).values[:, -1]
    own = []
    for r in range(64):
        cand = torch.nonzero(s64[r] >= thr[r]).squeeze(1)
        order = torch.sort(s64[r, cand], descending=True, stable=True).indices[:1000]
        own.append(cand[order])
    own = torch.stack(own).cpu().numpy()
    del s64
    check(bool((own == ids1000[:64]).all()), "k=1000 ids differ from the kernel's own stable top-k")
    check(bool((own[:, :100] == ids100[:64]).all()), "k=100 ids differ from the kernel's own stable top-k")
    say("search_checks", rr10=agg["RR@10"], ndcg10=agg["nDCG@10"], overlap_k100=ov100,
        overlap_k1000=ov1000, own_scores_ids_equal_64q=True, oracle_top1_top2_min_gap=gap,
        oracle_s=round(oracle_s, 2), planted_is_top1_frac=float((ids100[:, 0] == planted.numpy()).mean()))

    # the same sweep fused: mix, search and (no qrels here) nothing else leave
    # the card until the (A, B, k) ids; the same blocks, mix and kernel, so
    # the ids are the unfused runs'
    from codemix_dense_retrieval_torch.pipeline.fused import fused_alpha_sweep, fused_alpha_sweep_guaranteed

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, fids, _, _ = fused_alpha_sweep(qa, qb, ALPHAS, index._docs_dev[0], index._counts_dev, 100,
                                      search_kwargs=index.search_kwargs, query_block=256)
    fids = fids.cpu().numpy()
    tf100 = time.perf_counter() - t0
    path_counts["fused"] = dict(kernels.LAUNCHES)
    check(path_counts["fused"]["binmax_only"] > 0 and path_counts["fused"]["cover_rescore"] > 0
          and path_counts["fused"]["super_select"] > 0,
          "the fused sweep did not launch kernel 5, cover_rescore and super_select")
    for ai, a in enumerate(ALPHAS):
        check(np.array_equal(fids[ai], run_ids(runs100[a], 100)), f"fused ids differ from the unfused run, alpha={a}")
    # the k=1000 run written from string rows (native and Python) and from row ids
    # with the index's docid table
    table_ids, table_sc = run_table(runs1000[0.5], 1000)
    table_docs = index.docids[table_ids]
    table_sc = table_sc.astype(np.float32)
    t0 = time.perf_counter()
    trec.write_run(work / "w_native.trec", qids, table_docs, table_sc, tag="onepass-cm")
    native_w_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trec._write_run_python(work / "w_python.trec", qids, table_docs, table_sc, "onepass-cm", 4)
    python_w_s = time.perf_counter() - t0
    docid_table = index.docid_table()
    t0 = time.perf_counter()
    trec.write_run(work / "w_table.trec", qids, table_ids, table_sc, tag="onepass-cm", table=docid_table)
    table_w_s = time.perf_counter() - t0
    check((work / "w_native.trec").read_bytes() == (work / "w_python.trec").read_bytes()
          == (work / "w_table.trec").read_bytes(), "the native, table and Python TREC writers differ")
    say("fused", alphas=len(ALPHAS), k=100, query_block=256,
        unfused_k100_queries_per_s=round(len(ALPHAS) * N_QUERIES / t100, 1),
        fused_k100_queries_per_s=round(len(ALPHAS) * N_QUERIES / tf100, 1), fused_ids_equal_unfused=True,
        k1000_queries_per_s_native_writer=round(N_QUERIES / t1000, 1),
        trec_k1000_lines=N_QUERIES * 1000, trec_write_native_s=round(native_w_s, 3),
        trec_write_python_s=round(python_w_s, 3), trec_write_table_s=round(table_w_s, 3),
        launches=path_counts["fused"])

    # ---------------- phase 5b: the same run over the int8 index ----------------
    mark("5b")
    t0 = time.perf_counter()
    host8 = torch.empty((N_ROWS, DIM), dtype=torch.int8)
    scales8 = torch.empty(N_ROWS, dtype=torch.float32)
    for c0 in range(0, N_ROWS, 1 << 20):  # one chunk of f32 at a time, never the index
        c1 = min(c0 + (1 << 20), N_ROWS)
        v8, s8 = quantize_rows(index._docs_dev[0][c0:c1])
        host8[c0:c1].copy_(v8)
        scales8[c0:c1].copy_(s8)
    del v8, s8
    index8 = DenseFlatIndex.from_store(
        ShardStore.build(host8, docids, dtype="int8", scales=scales8.numpy())
    ).to_device()
    torch.cuda.synchronize()
    build8_s = time.perf_counter() - t0
    check(index8._docs_dev[0].dtype == torch.int8 and index8._rows_per_shard >= topk.TWO_LEVEL_MIN_ROWS,
          "int8 index not int8 on the two-level route")
    out8 = work / "search_int8"
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    runs8_100 = run_vector_mix_search(index8, qids, qa, qb, ALPHAS, out8 / "k100", k=100, query_block=256)
    t8_100 = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs8_1000 = run_vector_mix_search(index8, qids, qa, qb, [0.5], out8 / "k1000", k=1000, query_block=256)
    t8_1000 = time.perf_counter() - t0
    path_counts["search_int8"] = dict(kernels.LAUNCHES)
    check(path_counts["search_int8"]["bin_scores_int8_bin_major"] > 0
          and path_counts["search_int8"]["super_select"] > 0,
          "int8 search did not launch kernel 4 bin-major and super_select")
    ids8_100 = run_ids(runs8_100[0.5], 100)
    ids8_1000 = run_ids(runs8_1000[0.5], 1000)
    for a in ALPHAS:
        run_ids(runs8_100[a], 100)
    cli_main(["evaluate", "--dataset", "smoke8", "--run", str(runs8_100[0.5]), "--qrels", str(qrels),
              "--outdir", str(work / "eval8"), "--metrics", "MRR@10", "nDCG@10", "R@100"])
    (agg8_path,) = (work / "eval8").glob("*-agg.json")
    agg8 = json.loads(agg8_path.read_text())
    check(agg8["RR@10"] == 100.0, f"int8 RR@10 {agg8['RR@10']}")
    # the exact int8 top-k: the same f32 mixed queries, quantized, against the plain int8 scores
    q8, qs8 = quantize_rows(mix05)
    d8_big, ds8_big = index8._docs_dev[0], index8.search_kwargs["doc_scales"][0]
    t0 = time.perf_counter()
    _, o8ids = exact_topk(lambda c0, c1: int8_ip_scores(q8, qs8, d8_big[c0:c1], ds8_big[c0:c1]),
                          N_ROWS, 1000)
    o8ids = o8ids.cpu().numpy()
    oracle8_s = time.perf_counter() - t0
    ov8_100, ov8_1000 = overlap(ids8_100, o8ids[:, :100]), overlap(ids8_1000, o8ids)
    check(bool((ids8_1000 == o8ids).all()) and bool((ids8_100 == o8ids[:, :100]).all())
          and ov8_100 == 1.0 and ov8_1000 == 1.0,
          f"int8 run ids differ from the exact int8 top-k (overlap {ov8_100} / {ov8_1000})")
    say("search_int8", rows=N_ROWS, rows_padded=index8._rows_per_shard, dim=DIM, dtype="int8",
        quantize_and_upload_s=round(build8_s, 2),
        k100_alphas=len(ALPHAS), k100_queries_per_s=round(len(ALPHAS) * N_QUERIES / t8_100, 1),
        k1000_queries_per_s=round(N_QUERIES / t8_1000, 1), query_block=256,
        launches=path_counts["search_int8"], rr10=agg8["RR@10"], ndcg10=agg8["nDCG@10"],
        ids_equal_exact_int8_topk_512q=True, overlap_exact_int8_k100=ov8_100,
        overlap_exact_int8_k1000=ov8_1000,
        recall_vs_f32_oracle_k100=overlap(ids8_100, oids[:, :100]),
        recall_vs_f32_oracle_k1000=overlap(ids8_1000, oids), exact_int8_oracle_s=round(oracle8_s, 2))
    del host8, scales8

    # ---------------- phase 5c: rescore search (kernel 5) ----------------
    mark("5c")
    q256 = q05[:256].contiguous()
    nv_big = index._counts_dev[0]
    kernels.reset_launch_counts()
    rescore_s = {}
    for _ in range(2):  # the second call is timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, rids100 = topk.topk_ip(q256, index._docs_dev[0], 100, method="bins_rescore", n_valid=nv_big)
        torch.cuda.synchronize()
        rescore_s["k100"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, rids1000 = topk.topk_ip_rescore_two_level(q256, index._docs_dev[0], 1000, n_valid=nv_big)
        torch.cuda.synchronize()
        rescore_s["k1000"] = time.perf_counter() - t0
    path_counts["rescore"] = dict(kernels.LAUNCHES)
    check(path_counts["rescore"]["binmax_only"] > 0 and path_counts["rescore"]["super_select"] > 0,
          "rescore search did not launch kernel 5 and super_select")
    rov100 = overlap(rids100.cpu().numpy(), oids[:256, :100])
    rov1000 = overlap(rids1000.cpu().numpy(), oids[:256])
    check(rov100 >= 0.999 and rov1000 >= 0.999, f"rescore oracle overlap {rov100} / {rov1000}")
    say("rescore", queries=256, k100_ms=rescore_s["k100"] * 1e3, k1000_ms=rescore_s["k1000"] * 1e3,
        overlap_k100=rov100, overlap_k1000=rov1000, launches=path_counts["rescore"])

    # ---------------- phase 5d: the sketch tier at full size ----------------
    mark("5d")
    from codemix_dense_retrieval_torch.ops.sketch import _sketch_with_err

    spec = torch.exp(-0.009 * torch.arange(DIM, device=dev, dtype=torch.float32))

    def aniso(x):
        y = x.to(dev, torch.float32) * spec
        return y / y.norm(dim=1, keepdim=True)

    t0 = time.perf_counter()
    docs5 = index._docs_dev[0]  # reshaped in place: the recipe of the JAX package's bench
    for c0 in range(0, N_ROWS, 1 << 20):
        c1 = min(c0 + (1 << 20), N_ROWS)
        docs5[c0:c1] = aniso(docs5[c0:c1]).to(torch.bfloat16)
    qa5, qb5 = aniso(qa_t).cpu().numpy(), aniso(qb_t).cpu().numpy()
    index.enable_sketch(sketch_dim=128, cache=False)
    torch.cuda.synchronize()
    sketch_build_s = time.perf_counter() - t0
    out5d = work / "sketch"
    runs5d, cert5d, t5d = {}, {}, {}
    depths = ((100, ALPHAS), (1000, (0.5,)))
    kernels.reset_launch_counts()
    for mode, approx in (("fast", True), ("guaranteed", "guaranteed")):
        for k, alphas in depths:
            t0 = time.perf_counter()
            for a in alphas:  # one alpha per call, to keep each alpha's certificates
                runs5d[(mode, k, a)] = run_vector_mix_search(
                    index, qids, qa5, qb5, [a], out5d / f"{mode}{k}", k=k, query_block=256, approx=approx,
                )[a]
                cert5d[(mode, k, a)] = index.last_certified.copy()
            t5d[(mode, k)] = time.perf_counter() - t0
    # k = 1 at alpha = .5: each query's planted row lies far above the rest, so
    # certificates fire at full size and their soundness is held on real cases
    t0 = time.perf_counter()
    runs5d[("fast", 1, 0.5)] = run_vector_mix_search(
        index, qids, qa5, qb5, [0.5], out5d / "fast1", k=1, query_block=256, approx=True,
    )[0.5]
    cert5d[("fast", 1, 0.5)] = index.last_certified.copy()
    t5d[("fast", 1)] = time.perf_counter() - t0
    path_counts["sketch"] = dict(kernels.LAUNCHES)
    check(path_counts["sketch"]["binub"] > 0 and path_counts["sketch"]["super_select"] > 0,
          "the sketch runs did not launch kernel 7 and super_select")
    kernels.reset_launch_counts()
    for k, alphas in depths:
        t0 = time.perf_counter()
        ex = run_vector_mix_search(index, qids, qa5, qb5, list(alphas), out5d / f"exact{k}", k=k, query_block=256)
        t5d[("exact", k)] = time.perf_counter() - t0
        for a in alphas:
            runs5d[("exact", k, a)] = ex[a]
    path_counts["sketch_exact"] = dict(kernels.LAUNCHES)

    def mixed5(a):
        """The queries the index scores: the bf16 mix of the reshaped pair."""
        return mix_and_renorm(torch.from_numpy(qa5).to(dev), torch.from_numpy(qb5).to(dev), a)

    def row_scores(q, ids):
        """f32 products of queries q (n, d) with their rows ids (n, k)."""
        out = []
        for i in range(0, len(ids), 64):
            rows = docs5[torch.from_numpy(ids[i : i + 64]).to(dev)].float()
            out.append(torch.bmm(rows, q[i : i + 64, :, None])[:, :, 0])
        return torch.cat(out)

    def tie_check(q, got, want, tol):
        """(rows equal, rows that differ only where the swapped entries'
        scores lie within tol, violating rows) over the rows of got/want."""
        eq = (got == want).all(axis=1)
        diff = np.flatnonzero(~eq)
        bad = 0
        if len(diff):
            qd = q[torch.from_numpy(diff).to(dev)]
            gap = (row_scores(qd, got[diff]) - row_scores(qd, want[diff])).abs()
            bad = int((gap > tol).any(dim=1).sum().item())
        return int(eq.sum()), len(diff) - bad, bad

    cert_frac, recall5d, certified = {}, {}, [0, 0, 0, 0]
    grt_eq = 0
    grt_score_gap = 0.0
    for k, alphas in depths:
        for a in alphas:
            q = mixed5(a).to(torch.bfloat16).float()
            ex_ids, ex_sc = run_table(runs5d[("exact", k, a)], k)
            f_ids, _ = run_table(runs5d[("fast", k, a)], k)
            cert = cert5d[("fast", k, a)]
            cert_frac[f"k{k}_a{a}"] = float(cert.mean())
            recall5d[f"k{k}_a{a}"] = overlap(f_ids, ex_ids)
            c = np.flatnonzero(cert)
            n_eq, n_tie, n_bad = tie_check(q[torch.from_numpy(c).to(dev)], f_ids[c], ex_ids[c], TIE_TOL)
            certified = [certified[0] + len(c), certified[1] + n_eq, certified[2] + n_tie, certified[3] + n_bad]
            # guaranteed mode answers every uncertified query by exact search:
            # its ids are the exact run's, with no tie allowance
            g_ids, g_sc = run_table(runs5d[("guaranteed", k, a)], k)
            grt_eq += int((g_ids == ex_ids).all(axis=1).sum())
            grt_score_gap = max(grt_score_gap, float(np.abs(g_sc - ex_sc).max()))
            check(bool(cert5d[("guaranteed", k, a)].all()), "guaranteed mode left a query uncertified")
    check(certified[3] == 0, f"{certified[3]} certified queries differ from exact search beyond ties")
    n_runs = {100: len(ALPHAS) * N_QUERIES, 1000: N_QUERIES}
    check(grt_eq == n_runs[100] + n_runs[1000],
          f"{n_runs[100] + n_runs[1000] - grt_eq} guaranteed queries differ from the exact run's ids")
    ex_top1 = run_table(runs5d[("exact", 100, 0.5)], 100)[0][:, :1]  # the exact top-1
    f1_ids, _ = run_table(runs5d[("fast", 1, 0.5)], 1)
    c1 = np.flatnonzero(cert5d[("fast", 1, 0.5)])
    top1 = tie_check(mixed5(0.5).to(torch.bfloat16).float()[torch.from_numpy(c1).to(dev)],
                     f1_ids[c1], ex_top1[c1], TIE_TOL)
    check(len(c1) > 0, "no planted query was certified at k = 1: the certificate never fired at full size")
    check(top1[2] == 0, f"{top1[2]} certified k = 1 queries differ from exact search beyond ties")
    check(grt_score_gap <= 1e-4 + 1e-6, f"guaranteed vs exact TREC score gap {grt_score_gap}")
    # the fused sweep on this index, exact and guaranteed: the same ids
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    _, fe_ids, _, _ = fused_alpha_sweep(qa5, qb5, ALPHAS, index._docs_dev[0], index._counts_dev, 100,
                                        search_kwargs=index.search_kwargs, query_block=256)
    fe_ids = fe_ids.cpu().numpy()
    tfe = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, fg_ids, _, fg_cert = fused_alpha_sweep_guaranteed(
        qa5, qb5, ALPHAS, index._docs_dev[0], index._counts_dev, 100, sketch=index._sketch,
        search_kwargs=index.search_kwargs, query_block=256)
    tfg = time.perf_counter() - t0
    # k = 1, where the planted queries certify at alpha = .5: the fast sweep
    # keeps its certified rows, and the guaranteed one escalates only the rest
    sweep1 = dict(search_kwargs=index.search_kwargs, query_block=256)
    _, fe1, _, _ = fused_alpha_sweep(qa5, qb5, ALPHAS, index._docs_dev[0], index._counts_dev, 1, **sweep1)
    t0 = time.perf_counter()
    _, ff1, _, ff1_cert = fused_alpha_sweep(qa5, qb5, ALPHAS, index._docs_dev[0], index._counts_dev, 1,
                                            sketch=index._sketch, **sweep1)
    ff1, ff1_cert = ff1.cpu().numpy(), ff1_cert.cpu().numpy()
    tff1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, fg1, _, fg1_cert = fused_alpha_sweep_guaranteed(qa5, qb5, ALPHAS, index._docs_dev[0], index._counts_dev, 1,
                                                       sketch=index._sketch, **sweep1)
    tfg1 = time.perf_counter() - t0
    path_counts["fused_sketch"] = dict(kernels.LAUNCHES)
    fe1 = fe1.cpu().numpy()
    check(path_counts["fused_sketch"]["binub"] > 0 and path_counts["fused_sketch"]["super_select"] > 0,
          "the guaranteed fused sweep did not launch kernel 7 and super_select")
    check(np.array_equal(fg_ids, fe_ids), "guaranteed fused ids differ from the exact fused sweep's")
    fused_k1 = [0, 0, 0]  # certified rows: equal, equal up to ties, differing
    for ai, a in enumerate(ALPHAS):
        c = np.flatnonzero(ff1_cert[ai])
        if len(c):
            r = tie_check(mixed5(a).to(torch.bfloat16).float()[torch.from_numpy(c).to(dev)], ff1[ai, c], fe1[ai, c],
                          TIE_TOL)
            fused_k1 = [x + y for x, y in zip(fused_k1, r)]
    say("fused_sketch", alphas=len(ALPHAS), k=100, exact_queries_per_s=round(len(ALPHAS) * N_QUERIES / tfe, 1),
        guaranteed_queries_per_s=round(len(ALPHAS) * N_QUERIES / tfg, 1),
        certified_frac=float(fg_cert.mean()), guaranteed_ids_equal_exact=True,
        k1_fast_queries_per_s=round(len(ALPHAS) * N_QUERIES / tff1, 1),
        k1_guaranteed_queries_per_s=round(len(ALPHAS) * N_QUERIES / tfg1, 1),
        k1_certified_frac_fast=float(ff1_cert.mean()), k1_certified_frac_guaranteed=float(fg1_cert.mean()),
        k1_certified_ids_equal_exact=fused_k1[0], k1_certified_equal_up_to_ties=fused_k1[1],
        k1_guaranteed_ids_equal_exact=bool(np.array_equal(fg1, fe1)), launches=path_counts["fused_sketch"])
    check(ff1_cert.any() and fg1_cert.any(), "no (alpha, query) pair certified in the fused k = 1 sweeps")
    check(fused_k1[2] == 0, f"{fused_k1[2]} certified fused k = 1 rows differ from the exact sweep beyond ties")
    check(np.array_equal(fg1, fe1), "guaranteed fused ids at k = 1 differ from the exact fused sweep's")
    t0 = time.perf_counter()
    cal = index.calibrate_sketch(mixed5(0.5).cpu().numpy(), 100, recall_target=0.99)
    cal_s = time.perf_counter() - t0
    say("sketch", rows=N_ROWS, sketch_dim=128, reshape="column i x exp(-0.009 i), renormalised",
        build_s=round(sketch_build_s, 2),
        queries_per_s={f"{m}_k{k}": round(n_runs[k] / t5d[(m, k)], 1)
                       for m in ("fast", "guaranteed", "exact") for k in (100, 1000)}
        | {"fast_k1_a0.5": round(N_QUERIES / t5d[("fast", 1)], 1)},
        certified_frac_fast=cert_frac, recall_fast_vs_exact=recall5d,
        certified_queries=certified[0], certified_ids_equal=certified[1],
        certified_equal_up_to_ties=certified[2], guaranteed_ids_equal=grt_eq,
        guaranteed_max_trec_score_gap=grt_score_gap, certified_k1_a05=len(c1),
        certified_k1_ids_equal=top1[0], certified_k1_equal_up_to_ties=top1[1],
        tie_tol=TIE_TOL, calibrate_k100_recall099=cal, calibrate_s=round(cal_s, 2),
        launches=path_counts["sketch"], exact_launches=path_counts["sketch_exact"])

    # kernel 7 at the sketch tier's main shape, while the sidecar is alive
    (sk5,), (tl5,), proj5, _ = index._sketch
    nv_big = index._counts_dev[0]
    q_sk, q_tl, _ = _sketch_with_err(mixed5(0.5)[:256].to(torch.bfloat16).float(), proj5, torch.bfloat16)
    nb5 = sk5.shape[0]
    ub = sk.binub(q_sk, q_tl, sk5, tl5, 8, nv_big)
    ub2 = sk.binub_plain(q_sk, q_tl, sk5, tl5, 8, nv_big)
    torch.cuda.synchronize()
    err7 = (ub - ub2).abs().max().item()
    check(err7 <= TOL_BINUB, f"7 err {err7} at the main shape")
    check(bool((ub[:, -(-N_ROWS // 8):] == topk.NEG_INF).all()), "7 pad bins at the main shape")
    del ub, ub2
    col5 = torch.arange(nb5, device=dev)

    def lib_binub():
        s = torch.matmul(q_sk, sk5.T).float()
        s.addr_(q_tl, tl5)
        return s.masked_fill_(col5 >= nv_big, -torch.inf).view(256, nb5 // 8, 8).amax(dim=2)

    b_ms, b_by = bound(256 * 128 * 2 + 256 * 4 + nb5 * 128 * 2 + nb5 * 4 + 256 * nb5 // 8 * 4,
                       2 * 256 * nb5 * 128)
    late_entries = [dict(
        name="binub", route="cuda", source="codemix_dense_retrieval_torch/csrc/bin_scores.cu",
        replaces="codemix_dense_retrieval_tpu/ops/sketch.py:310", launches=None,
        max_abs_err=max(errs["binub"], err7),
        **kernel_ms(lambda: sk.binub(q_sk, q_tl, sk5, tl5, 8, nv_big), 5),
        plain_ms=cuda_ms(lambda: sk.binub_plain(q_sk, q_tl, sk5, tl5, 8, nv_big), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib_binub, 3),
        shape=f"B=256 N={nb5} ds=128 G=8 bf16 sketch, bin-major upper-bound maxima",
    )]
    index._sketch = None
    del sk5, tl5, q_sk, q_tl, col5, docs5  # the rows stay with the index until phase 7
    torch.cuda.empty_cache()

    # ---------------- phase 5e: the adaptive tier at full size ----------------
    mark("5e")
    # clustered rows of its own (18.1 GB more on the card: phases 6-8 still
    # need the phase-5 index): the JAX bench recipe, 256 unit centres and
    # row i = normalize(center[a_i] + 0.35/sqrt(d) noise_i), the assignments
    # in random order, as a user's index arrives
    import threading

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ge = torch.Generator(device=dev).manual_seed(SEED + 6)
    centers = torch.randn(N_CENTERS, DIM, device=dev, generator=ge)
    centers /= centers.norm(dim=1, keepdim=True)
    assign = torch.randint(0, N_CENTERS, (N_ROWS,), device=dev, generator=ge)
    host5e = torch.empty((N_ROWS, DIM), dtype=torch.bfloat16)
    for c0 in range(0, N_ROWS, 1 << 20):
        c1 = min(c0 + (1 << 20), N_ROWS)
        x = centers[assign[c0:c1]] + (0.35 / DIM ** 0.5) * torch.randn(c1 - c0, DIM, device=dev, generator=ge)
        host5e[c0:c1].copy_((x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16))
    x = centers[torch.randint(0, N_CENTERS, (N_QUERIES,), device=dev, generator=ge)]
    x = x + (0.35 / DIM ** 0.5) * torch.randn(N_QUERIES, DIM, device=dev, generator=ge)
    q5e = (x / x.norm(dim=1, keepdim=True)).cpu().numpy()
    del x, assign
    index5e = DenseFlatIndex.build(host5e, docids).to_device()
    del host5e  # the store holds the rows; reorder_rows replaces it
    gen5e_s = time.perf_counter() - t0
    q_blk = q5e[:256]  # one query block: the escalation branch is per block

    def search5e(q, k, **kw):
        return index5e.search(q, k, return_docids=False, query_block=256, **kw)

    adaptive_counts = []

    def adaptive5e(q, k, **kw):
        """An adaptive search, its launches counted apart from the exact
        searches it is compared with."""
        kernels.reset_launch_counts()
        out = search5e(q, k, approx="adaptive", **kw)
        adaptive_counts.append(dict(kernels.LAUNCHES))
        return out, dict(index5e.last_adaptive_stats)

    def same5e(got, want, label):
        check(np.array_equal(got[1], want[1]) and np.array_equal(got[0], want[0]),
              f"adaptive ids or values differ from exact search: {label}")

    grid5e = {k: sorted({-(-k // 8) * f for f in (1, 2, 4, 8, 16)} | {int(k * x) for x in (0.9, 0.95, 1.0)})
              for k in (100, 1000)}

    def cert_grid():
        """Certified share of the first block at each probe depth."""
        return {k: {p: adaptive5e(q_blk, k, probe_bins=p)[1]["certified_frac"] for p in grid5e[k]} for k in grid5e}

    # 1. before the reorder: the default probe, and the > B/2 branch
    ex_pre = search5e(q5e, 100)
    ad_pre, st_pre = adaptive5e(q5e, 100)
    same5e(ad_pre, ex_pre, "k=100 before the reorder")
    grid_pre = cert_grid()
    br_exact, st_br_exact = adaptive5e(q_blk, 100)
    check(st_br_exact.get("escalated", 0) > 128, f"random row order: {st_br_exact} (> B/2 branch not taken)")
    same5e(br_exact, (ex_pre[0][:256], ex_pre[1][:256]), "the > B/2 branch")
    # 2. the reorder, its host seconds and the process's peak resident set
    rss = {"before": 0, "peak": 0}
    page = os.sysconf("SC_PAGE_SIZE")

    def rss_now():
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * page

    sampling = threading.Event()

    def sample_rss():
        while not sampling.is_set():
            rss["peak"] = max(rss["peak"], rss_now())
            time.sleep(0.05)

    rss["before"] = rss_now()
    sampler = threading.Thread(target=sample_rss)
    sampler.start()
    t0 = time.perf_counter()
    try:
        perm5e = index5e.reorder_rows()
    finally:
        sampling.set()
        sampler.join()
    reorder_s = time.perf_counter() - t0
    check(np.array_equal(np.sort(perm5e), np.arange(N_ROWS)) and index5e.mutation_epoch == 1,
          "reorder_rows did not return a permutation")
    grid_post = cert_grid()
    # 3. calibration at both depths (first 256 queries as the sample)
    cal5e = {k: index5e.calibrate_adaptive(q_blk, k) for k in (100, 1000)}
    # 4. adaptive against exact search of the 512 queries, in turns
    qps5e, stats5e, exact5e = {}, {}, {}
    for k in (100, 1000):
        runs = {"exact": [], "adaptive": []}
        for mode in ("exact", "adaptive", "adaptive", "exact"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "exact":
                out = search5e(q5e, k)
            else:
                out, stats5e[k] = adaptive5e(q5e, k)
            runs[mode].append((time.perf_counter() - t0, out))
        ex = runs["exact"][0][1]
        for _, out in runs["adaptive"] + runs["exact"][1:]:
            same5e(out, ex, f"k={k} after the reorder")
        qps5e[k] = {m: round(N_QUERIES * len(r) / sum(t for t, _ in r), 1) for m, r in runs.items()}
        exact5e[k] = ex
    # docids follow perm: the exact top-100 before and after the reorder have
    # the same scores and name the same passages, order free only among
    # equal scores (and at the k-th score, which may tie with row 101)
    moved = np.asarray(docids, dtype=object)[ex_pre[1]] != index5e.docids[exact5e[100][1]]
    tied = ex_pre[0] == ex_pre[0][:, -1:]
    tied[:, 1:] |= ex_pre[0][:, 1:] == ex_pre[0][:, :-1]
    tied[:, :-1] |= ex_pre[0][:, :-1] == ex_pre[0][:, 1:]
    follow = {"score_rows_differ": int((exact5e[100][0] != ex_pre[0]).any(axis=1).sum()),
              "rows_reordered_within_ties": int((moved & tied).any(axis=1).sum()),
              "rows_moved_beyond_ties": int((moved & ~tied).any(axis=1).sum())}
    check(follow["score_rows_differ"] == 0 and follow["rows_moved_beyond_ties"] == 0,
          f"the exact top-100 changed with the row order: {follow}")
    # 5. guaranteed mode: the adaptive route where calibration measured >= 1.05x
    routes = {}
    for k in (100, 1000):
        kernels.reset_launch_counts()
        g_out = search5e(q5e, k, approx="guaranteed")
        adaptive_counts.append(dict(kernels.LAUNCHES))
        routes[k] = index5e.last_guaranteed_route
        check(np.array_equal(g_out[1], exact5e[k][1]), f"guaranteed ids differ from exact search at k={k}")
        if cal5e[k]["speedup"] >= ADAPTIVE_ROUTE_MARGIN:
            check(routes[k] == "adaptive", f"calibrated speedup {cal5e[k]['speedup']} but route {routes[k]}")
    index5e._sketch = None
    # 6. the <= B/2 branch: a probe depth that leaves some, at most half, of
    # the block uncertified (bisection between the post-reorder grid's
    # probes on either side of half certified; the calibrated depth follows
    # the timer, and timing noise can put it below the transition)
    over = sorted(p for p, c in grid_post[100].items() if c >= 0.5)
    hi = over[0] if over else max(grid_post[100])
    lo = max([p for p in grid_post[100] if p < hi] or [-(-100 // 8)])
    br_tail = None
    for _ in range(12):
        mid = (lo + hi) // 2
        out, st = adaptive5e(q_blk, 100, probe_bins=mid)
        esc = st.get("escalated", 0)
        if 0 < esc <= 128:
            br_tail = (mid, st, out)
            break
        lo, hi = (mid, hi) if esc > 128 else (lo, mid)
        if hi - lo <= 1:
            break
    check(br_tail is not None, "no probe depth left 1..128 of 256 queries uncertified")
    same5e(br_tail[2], (exact5e[100][0][:256], exact5e[100][1][:256]), "the <= B/2 branch")
    path_counts["adaptive"] = {kk: sum(c[kk] for c in adaptive_counts) for kk in adaptive_counts[0]}
    check(path_counts["adaptive"]["bin_scores_bin_major"] > 0 and path_counts["adaptive"]["super_select"] > 0,
          "the adaptive tier did not launch kernel A and super_select")
    # the reorder's own effect at equal probe depths, and what a user sees:
    # the default probe before it against the calibrated one after it
    check(any(grid_post[k][p] > grid_pre[k][p] for k in grid5e for p in grid5e[k]),
          f"the reorder raised the certified share at no probe depth: {grid_pre} -> {grid_post}")
    check(stats5e[100]["certified_frac"] > st_pre["certified_frac"],
          f"certified share {st_pre['certified_frac']} before the reorder, {stats5e[100]['certified_frac']} after")
    say("adaptive", rows=N_ROWS, centers=N_CENTERS, noise="0.35/sqrt(d)", row_order="random assignments",
        gen_s=round(gen5e_s, 2), card_peak_gb=round(torch.cuda.max_memory_allocated() / 1e9, 2),
        certified_frac_before_k100_default_probe=st_pre,
        reorder_s=round(reorder_s, 2), reorder_steps_s=index5e.last_reorder_stats,
        host_rss_gb={"before": round(rss["before"] / 1e9, 2), "peak": round(rss["peak"] / 1e9, 2)},
        certified_by_probe={"before": grid_pre, "after": grid_post},
        exact_top100_across_the_reorder=follow,
        calibration=cal5e, queries_per_s=qps5e, stats_after=stats5e, guaranteed_routes=routes,
        branch_exact=st_br_exact, branch_tail={"probe_bins": br_tail[0], **br_tail[1]},
        ids_and_values_equal_exact=True, launches=path_counts["adaptive"])
    del index5e, ex_pre, ad_pre, br_exact, exact5e, runs, out, g_out, br_tail, moved, tied
    torch.cuda.empty_cache()

    # ---------------- phase 6: CLI at full width ----------------
    mark("6")
    t0 = time.perf_counter()
    small = torch.empty((SMALL_ROWS, DIM), dtype=torch.bfloat16)
    for c0 in range(0, SMALL_ROWS, 1 << 16):
        x = torch.randn(1 << 16, DIM, device=dev, generator=gi)
        small[c0 : c0 + (1 << 16)].copy_((x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16))
    ShardStore.build(small, [f"s{i}" for i in range(SMALL_ROWS)], lang="xx").save(work / "small")
    write_s = time.perf_counter() - t0
    argv = ["codemix_dense_retrieval_torch", "run-mix", "--checkpoint", str(ckpt),
            "--index", str(work / "small"), "--query_tsv", f"en={work / 'en.tsv'}",
            f"zh={work / 'zh.tsv'}", "--outdir", str(work / "cli_runs"), "--k", "100",
            "--qblock", "256", "--cm_alphas", "0", "0.5", "1", "--seed", str(SEED)]

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run_cli(argv)
    cli_s = time.perf_counter() - t0
    path_counts["cli"] = dict(kernels.LAUNCHES)
    check(path_counts["cli"]["bin_scores_transposed"] > 0, "CLI did not launch kernel 2 (transposed)")
    small_dev = DenseFlatIndex.load(work / "small").to_device()
    check(small_dev._rows_per_shard < topk.TWO_LEVEL_MIN_ROWS, "CLI store not on the single-level route")

    def cli_ids(alpha_label):
        ids = {}
        with open(work / "cli_runs" / f"cm-alpha-{alpha_label}.trec") as fh:
            for line in fh:
                qid, _, doc, _, _, _ = line.split()
                ids.setdefault(qid, []).append(int(doc[1:]))
        check(len(ids) == N_QUERIES and all(len(v) == 100 for v in ids.values()), "CLI run shape")
        return np.array([ids[q] for q in qids])

    for label in ("0", "1"):
        cli_ids(label)
    _, soids = oracle_topk(q05.float(), small_dev._docs_dev[0], SMALL_ROWS, 100)
    cli_ov = overlap(cli_ids("0.5"), soids.cpu().numpy())
    check(cli_ov >= 0.999, f"CLI alpha=0.5 oracle overlap {cli_ov}")
    # run-mix --approx adaptive over the same store: the probed cover on
    # kernel A (bin-major at every size), escalation on kernel 2; the run
    # files are --approx off's byte for byte
    ad_argv = [a if a != str(work / "cli_runs") else str(work / "cli_adaptive") for a in argv]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run_cli([*ad_argv, "--approx", "adaptive"])
    cli_ad_s = time.perf_counter() - t0
    path_counts["cli_adaptive"] = dict(kernels.LAUNCHES)
    check(path_counts["cli_adaptive"]["bin_scores_bin_major"] > 0 and path_counts["cli_adaptive"]["super_select"] > 0,
          "run-mix --approx adaptive did not launch kernel A and super_select")
    for label in ("0", "0.5", "1"):
        name = f"cm-alpha-{label}.trec"
        check((work / "cli_adaptive" / name).read_bytes() == (work / "cli_runs" / name).read_bytes(),
              f"run-mix --approx adaptive {name} differs from --approx off's")
    cli_ad_meta = json.loads((work / "cli_adaptive" / "cm-alpha-0.5_meta.json").read_text())
    say("cli", checkpoint="params.npz + encoder_config.json (BGE-M3 width, f32)", store_rows=SMALL_ROWS,
        write_s=round(write_s, 2), run_s=round(cli_s, 2), overlap_k100=cli_ov,
        launches=path_counts["cli"], adaptive_run_s=round(cli_ad_s, 2), adaptive_runs_byte_equal=True,
        adaptive_meta=cli_ad_meta, adaptive_launches=path_counts["cli_adaptive"])

    # run-mix --fused --qrels over the same store: the unfused run's ids, and
    # the metrics per alpha (qrels: the f32 oracle's top-1 at alpha = .5)
    qrels_s = work / "qrels_small.tsv"
    top1_s = soids[:, 0].cpu().numpy()
    qrels_s.write_text("".join(f"{q}\ts{top1_s[i]}\t1\n" for i, q in enumerate(qids)))
    fused_argv = [a if a != str(work / "cli_runs") else str(work / "cli_fused") for a in argv]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cli_fused = run_cli_json([*fused_argv, "--fused", "--qrels", str(qrels_s)])
    cli_fused_s = time.perf_counter() - t0
    path_counts["cli_fused"] = dict(kernels.LAUNCHES)
    check(path_counts["cli_fused"]["bin_scores_transposed"] > 0, "run-mix --fused did not launch kernel 2")
    for label in ("0", "0.5", "1"):
        got = {}
        with open(work / "cli_fused" / f"cm-alpha-{label}.trec") as fh:
            for line in fh:
                qid, _, doc, _, _, _ = line.split()
                got.setdefault(qid, []).append(int(doc[1:]))
        check(np.array_equal(np.array([got[q] for q in qids]), cli_ids(label)),
              f"run-mix --fused ids differ from the unfused run's, alpha={label}")
        check({"run", "RR@10", "nDCG@10", "R@100", "AP"} <= set(cli_fused[label]), f"run-mix --fused payload {label}")
    # a parallel second language of the same store, and run-bilingual-mix
    # --fused over the two (262,144 rows: the two-level route)
    small2 = torch.empty_like(small)
    for c0 in range(0, SMALL_ROWS, 1 << 16):
        x = small[c0 : c0 + (1 << 16)].to(dev).float()
        u = torch.randn(x.shape, device=dev, generator=gi)
        y = x + 0.3 * u / u.norm(dim=1, keepdim=True)
        small2[c0 : c0 + (1 << 16)].copy_((y / y.norm(dim=1, keepdim=True)).to(torch.bfloat16))
    ShardStore.build(small2, [f"s{i}" for i in range(SMALL_ROWS)], lang="yy").save(work / "small2")
    del small2
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cli_bi = run_cli_json(["codemix_dense_retrieval_torch", "run-bilingual-mix", "--checkpoint", str(ckpt),
                           "--index", str(work / "small"), str(work / "small2"), "--query_tsv",
                           f"en={work / 'en.tsv'}", f"zh={work / 'zh.tsv'}", "--outdir", str(work / "cli_bi"),
                           "--k", "100", "--qblock", "256", "--cm_alphas", "0", "0.5", "1", "--fused",
                           "--qrels", str(qrels_s), "--seed", str(SEED)])
    cli_bi_s = time.perf_counter() - t0
    path_counts["cli_bilingual_fused"] = dict(kernels.LAUNCHES)
    check(path_counts["cli_bilingual_fused"]["binmax_only"] > 0
          and path_counts["cli_bilingual_fused"]["cover_rescore"] > 0
          and path_counts["cli_bilingual_fused"]["super_select"] > 0,
          "run-bilingual-mix --fused did not launch kernel 5, cover_rescore and super_select")
    check(sorted(cli_bi) == ["0.0", "0.5", "1.0"], f"run-bilingual-mix --fused payload {sorted(cli_bi)}")
    for a, entry in cli_bi.items():
        n_lines = len(pathlib.Path(entry["run"]).read_text().splitlines())
        check(n_lines == N_QUERIES * 100 and "RR@10" in entry, f"run-bilingual-mix --fused run {a}: {n_lines} lines")
    say("cli_fused", run_mix_fused_s=round(cli_fused_s, 2), run_mix_fused_ids_equal_unfused=True,
        run_mix_fused_metrics={a: {m: v for m, v in e.items() if m in ("RR@10", "nDCG@10", "R@100")}
                               for a, e in cli_fused.items()},
        run_bilingual_mix_fused_s=round(cli_bi_s, 2), hub_rows=2 * SMALL_ROWS,
        run_bilingual_mix_fused_metrics={a: {m: v for m, v in e.items() if m in ("RR@10", "nDCG@10", "R@100")}
                                         for a, e in cli_bi.items()},
        launches={"run_mix": path_counts["cli_fused"], "run_bilingual_mix": path_counts["cli_bilingual_fused"]})

    # ---------------- phase 6b: encode-corpus (int8) + run-mix over it ----------------
    mark("6b")

    corpus_tsv = work / "corpus.tsv"
    corpus_tsv.write_text("".join(f"c{i}\t{sentence('p', 600, 1000, 50_000)}\n" for i in range(N_CORPUS)))
    corpus_yy = work / "corpus_yy.tsv"  # a second language for the bilingual two-stage
    corpus_yy.write_text("".join(f"c{i}\t{sentence('y', 600, 1000, 50_000)}\n" for i in range(N_CORPUS_YY)))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run_cli(["codemix_dense_retrieval_torch", "encode-corpus", "--checkpoint", str(ckpt),
             "--corpus_tsv", f"xx={corpus_tsv}", f"yy={corpus_yy}", "--storage_dtype", "int8",
             "--out", str(work / "corpus"), "--batch", "512", "--enc_batch", "32", "--tokens_per_doc", str(TD),
             "--seed", str(SEED)])
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_cli(["codemix_dense_retrieval_torch", "run-mix", "--checkpoint", str(ckpt),
             "--index", str(work / "corpus" / "xx"), "--query_tsv", f"en={work / 'en.tsv'}",
             f"zh={work / 'zh.tsv'}", "--outdir", str(work / "corpus_runs"), "--k", "100",
             "--qblock", "256", "--cm_alphas", "0.5", "--query_cache", str(work / "qcache"),
             "--seed", str(SEED)])
    corpus_run_s = time.perf_counter() - t0
    path_counts["corpus_cli"] = dict(kernels.LAUNCHES)
    check(path_counts["corpus_cli"]["bin_scores_int8_transposed"] > 0,
          "run-mix over the int8 store did not launch kernel 4 transposed")
    store8 = ShardStore.open(work / "corpus" / "xx")
    check(store8.count == N_CORPUS and store8.manifest.dtype == "int8"
          and (work / "corpus" / "xx" / "scales.bin").exists() and store8.scales.shape == (N_CORPUS,),
          "encode-corpus int8 store shape / scales.bin")
    _, va = load_query_cache(work / "qcache" / "en" / "queries.npz", expected_qids=qids)
    _, vb = load_query_cache(work / "qcache" / "zh" / "queries.npz", expected_qids=qids)
    cq8, cqs8 = quantize_rows(mix_and_renorm(torch.from_numpy(va).to(dev), torch.from_numpy(vb).to(dev), 0.5))
    cd8 = store8.rows().to(dev)
    want8 = topk._stable_topk(int8_ip_scores(cq8, cqs8, cd8, torch.from_numpy(store8.scales).to(dev)), 100)[1]
    got8 = {}
    with open(work / "corpus_runs" / "cm-alpha-0.5.trec") as fh:
        for line in fh:
            qid, _, doc, _, _, _ = line.split()
            got8.setdefault(qid, []).append(int(doc.split("#")[0][1:]))
    check(len(got8) == N_QUERIES and all(len(v) == 100 for v in got8.values()), "corpus run shape")
    check(bool((np.array([got8[q] for q in qids]) == want8.cpu().numpy()).all()),
          "run-mix over the int8 store differs from the exact int8 top-k")
    # --approx adaptive over the int8 store: exact search (kernel 4), the same ids
    kernels.reset_launch_counts()
    run_cli(["codemix_dense_retrieval_torch", "run-mix", "--checkpoint", str(ckpt),
             "--index", str(work / "corpus" / "xx"), "--query_tsv", f"en={work / 'en.tsv'}",
             f"zh={work / 'zh.tsv'}", "--outdir", str(work / "corpus_adaptive_runs"), "--k", "100",
             "--qblock", "256", "--cm_alphas", "0.5", "--query_cache", str(work / "qcache"),
             "--approx", "adaptive", "--seed", str(SEED)])
    path_counts["corpus_cli_adaptive"] = dict(kernels.LAUNCHES)
    check(path_counts["corpus_cli_adaptive"]["bin_scores_int8_transposed"] > 0,
          "run-mix --approx adaptive over the int8 store did not launch kernel 4")
    check((work / "corpus_adaptive_runs" / "cm-alpha-0.5.trec").read_bytes()
          == (work / "corpus_runs" / "cm-alpha-0.5.trec").read_bytes(),
          "run-mix --approx adaptive over the int8 store differs from the exact run")
    tok8 = TokenShardStore.open(work / "corpus" / "xx" / "tokens")
    check(tok8.count == N_CORPUS and tok8.tokens_per_doc == TD and tok8.docids == store8.docids
          and bool((tok8.lengths == TD).all()), "encode-corpus token store shape / alignment")

    def corpus_run_ids(path):
        got = {}
        with open(path) as fh:
            for line in fh:
                qid, _, doc, _, _, _ = line.split()
                got.setdefault(qid, []).append(int(doc.split("#")[0][1:]))
        check(len(got) == N_QUERIES and all(len(v) == 100 for v in got.values()), f"{path} shape")
        return np.array([got[q] for q in qids])

    # the same run through the int8 sketch tier, guaranteed: the exact int8 ids
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run_cli(["codemix_dense_retrieval_torch", "run-mix", "--checkpoint", str(ckpt),
             "--index", str(work / "corpus" / "xx"), "--query_tsv", f"en={work / 'en.tsv'}",
             f"zh={work / 'zh.tsv'}", "--outdir", str(work / "corpus_grt_runs"), "--k", "100",
             "--qblock", "256", "--cm_alphas", "0.5", "--query_cache", str(work / "qcache"),
             "--approx", "guaranteed", "--seed", str(SEED)])
    corpus_grt_s = time.perf_counter() - t0
    path_counts["corpus_grt"] = dict(kernels.LAUNCHES)
    check(path_counts["corpus_grt"]["binub"] > 0 and path_counts["corpus_grt"]["super_select"] > 0,
          "run-mix --approx guaranteed did not launch kernel 7 and super_select")
    check(bool((corpus_run_ids(work / "corpus_grt_runs" / "cm-alpha-0.5.trec") == want8.cpu().numpy()).all()),
          "run-mix --approx guaranteed over the int8 store differs from the exact int8 top-k")
    grt_meta = json.loads((work / "corpus_grt_runs" / "cm-alpha-0.5_meta.json").read_text())
    # run-mix --fused --qrels over the int8 store (kernel 4 inside the fused
    # sweep): the exact int8 ids; qrels: that top-1, under the derived id
    # (`c<i>#xx`) the run prints
    qrels8 = work / "qrels_corpus.tsv"
    top8 = want8[:, 0].cpu().numpy()
    qrels8.write_text("".join(f"{q}\t{store8.derived_ids[top8[i]]}\t1\n" for i, q in enumerate(qids)))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    corpus_fused = run_cli_json(["codemix_dense_retrieval_torch", "run-mix", "--checkpoint", str(ckpt),
                                 "--index", str(work / "corpus" / "xx"), "--query_tsv", f"en={work / 'en.tsv'}",
                                 f"zh={work / 'zh.tsv'}", "--outdir", str(work / "corpus_fused_runs"), "--k", "100",
                                 "--qblock", "256", "--cm_alphas", "0.5", "--query_cache", str(work / "qcache"),
                                 "--fused", "--qrels", str(qrels8), "--seed", str(SEED)])
    corpus_fused_s = time.perf_counter() - t0
    path_counts["corpus_cli_fused"] = dict(kernels.LAUNCHES)
    check(path_counts["corpus_cli_fused"]["bin_scores_int8_transposed"] > 0,
          "run-mix --fused over the int8 store did not launch kernel 4 transposed")
    check(bool((corpus_run_ids(work / "corpus_fused_runs" / "cm-alpha-0.5.trec") == want8.cpu().numpy()).all()),
          "run-mix --fused over the int8 store differs from the exact int8 top-k")
    check(corpus_fused["0.5"]["RR@10"] == 100.0, f"run-mix --fused int8 RR@10 {corpus_fused['0.5']['RR@10']}")
    # the two-stage CLI over the encode-corpus store and its token store
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run_cli(["codemix_dense_retrieval_torch", "run-rerank", "--checkpoint", str(ckpt),
             "--index", str(work / "corpus" / "xx"), "--queries", str(work / "en.tsv"),
             "--outdir", str(work / "rerank_runs"), "--k", "100", "--k_dense", str(K_DENSE),
             "--qblock", "256", "--seed", str(SEED)])
    rerank_cli_s = time.perf_counter() - t0
    path_counts["rerank_cli"] = dict(kernels.LAUNCHES)
    check(path_counts["rerank_cli"]["maxsim"] > 0, "run-rerank did not launch kernel 6")
    corpus_run_ids(work / "rerank_runs" / "en.trec")
    rerank_meta = json.loads((work / "rerank_runs" / "en_meta.json").read_text())
    check(rerank_meta["k_dense_effective"] == K_DENSE and rerank_meta["k_effective"] == 100,
          f"run-rerank depths {rerank_meta}")
    # run-rerank --approx adaptive: the dense stage through the adaptive tier
    # (exact search over this int8 store), the same ids
    kernels.reset_launch_counts()
    run_cli(["codemix_dense_retrieval_torch", "run-rerank", "--checkpoint", str(ckpt),
             "--index", str(work / "corpus" / "xx"), "--queries", str(work / "en.tsv"),
             "--outdir", str(work / "rerank_adaptive"), "--k", "100", "--k_dense", str(K_DENSE),
             "--qblock", "256", "--approx", "adaptive", "--seed", str(SEED)])
    path_counts["rerank_cli_adaptive"] = dict(kernels.LAUNCHES)
    check(path_counts["rerank_cli_adaptive"]["maxsim"] > 0, "run-rerank --approx adaptive did not launch kernel 6")
    check(np.array_equal(corpus_run_ids(work / "rerank_adaptive" / "en.trec"),
                         corpus_run_ids(work / "rerank_runs" / "en.trec")),
          "run-rerank --approx adaptive ids differ from --approx off's")
    # the bilingual two-stage: each language's two-stage search, merged and collapsed
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run_cli(["codemix_dense_retrieval_torch", "run-rerank", "--checkpoint", str(ckpt),
             "--index", str(work / "corpus" / "xx"), str(work / "corpus" / "yy"), "--queries", str(work / "en.tsv"),
             "--outdir", str(work / "rerank_bi"), "--k", "100", "--k_dense", str(K_DENSE),
             "--qblock", "256", "--seed", str(SEED)])
    rerank_bi_s = time.perf_counter() - t0
    path_counts["rerank_bilingual_cli"] = dict(kernels.LAUNCHES)
    check(path_counts["rerank_bilingual_cli"]["maxsim"] > 0, "run-rerank over two indexes did not launch kernel 6")
    raw_bi = run_table(work / "rerank_bi" / "en_raw.trec", 100, doc_int=lambda d: int(d.split("#")[0][1:]))[0]
    check(all(len(set(r)) >= 50 for r in raw_bi), "bilingual two-stage raw run shape")
    base_bi = (work / "rerank_bi" / "en_base.trec").read_text().splitlines()
    check(len({ln.split()[0] for ln in base_bi}) == N_QUERIES and all("#" not in ln for ln in base_bi),
          "bilingual two-stage collapsed run")
    say("corpus_cli", passages=N_CORPUS + N_CORPUS_YY, words_per_passage="600-1000", bucket=512,
        storage_dtype="int8", tokens_per_doc=TD, encode_corpus_s=round(encode_s, 2),
        passages_per_s=round((N_CORPUS + N_CORPUS_YY) / encode_s, 1), run_rerank_bilingual_s=round(rerank_bi_s, 2),
        run_rerank_bilingual_launches=path_counts["rerank_bilingual_cli"],
        run_mix_s=round(corpus_run_s, 2), store_rows=store8.count, ids_equal_exact_int8_topk=True,
        launches=path_counts["corpus_cli"], run_mix_guaranteed_s=round(corpus_grt_s, 2),
        guaranteed_ids_equal_exact_int8_topk=True, guaranteed_meta=grt_meta,
        guaranteed_launches=path_counts["corpus_grt"], run_mix_fused_s=round(corpus_fused_s, 2),
        fused_ids_equal_exact_int8_topk=True, fused_rr10=corpus_fused["0.5"]["RR@10"],
        fused_launches=path_counts["corpus_cli_fused"], run_rerank_s=round(rerank_cli_s, 2),
        run_rerank_launches=path_counts["rerank_cli"], adaptive_ids_equal_exact=True,
        adaptive_launches=path_counts["corpus_cli_adaptive"],
        run_rerank_adaptive_ids_equal=True, run_rerank_adaptive_launches=path_counts["rerank_cli_adaptive"])
    del cd8

    # ---------------- phase 6c: two-stage search at scale ----------------
    mark("6c")
    from codemix_dense_retrieval_torch.io.token_shards import TokenShardWriter
    from codemix_dense_retrieval_torch.parallel.sharded_search import _merge_two_key
    from codemix_dense_retrieval_torch.pipeline.query_cache import save_query_token_cache
    from codemix_dense_retrieval_torch.pipeline.rerank import (
        TwoStageSearcher,
        _dequant_bf16,
        run_two_stage_search,
    )

    g6 = torch.Generator(device=dev).manual_seed(SEED + 3)
    cpu6 = torch.Generator().manual_seed(SEED + 4)

    def unit6(*shape):
        x = torch.randn(*shape, device=dev, generator=g6)
        return x / x.norm(dim=-1, keepdim=True)

    t0 = time.perf_counter()
    q_lens6 = torch.randint(8, TQ + 1, (N_QUERIES,), generator=cpu6)
    q_mask6 = (torch.arange(TQ)[None, :] < q_lens6[:, None]).to(torch.int32).to(dev)
    q_toks6 = unit6(N_QUERIES, TQ, DIM) * q_mask6[..., None]  # pad tokens are 0, as encoded
    q_dense6 = q_toks6.sum(dim=1)
    q_dense6 /= q_dense6.norm(dim=1, keepdim=True)
    # one planted document per query: its dense row and its tokens sit near the query's
    planted6 = torch.randperm(SMALL_ROWS, generator=cpu6)[:N_QUERIES]
    plant_of = torch.full((SMALL_ROWS,), -1, dtype=torch.long)
    plant_of[planted6] = torch.arange(N_QUERIES)
    doc_lens6 = torch.randint(1, TD + 1, (SMALL_ROWS,), generator=cpu6)
    doc_lens6[planted6] = TD
    ids6 = [f"t{i}" for i in range(SMALL_ROWS)]
    dense6 = torch.empty((SMALL_ROWS, DIM), dtype=torch.bfloat16)
    writer = TokenShardWriter(work / "twostage" / "tokens", token_dim=DIM, tokens_per_doc=TD, dtype="int8")
    for c0 in range(0, SMALL_ROWS, 4096):
        c1 = c0 + 4096
        rows, toks = unit6(c1 - c0, DIM), unit6(c1 - c0, TD, DIM)
        sel = torch.nonzero(plant_of[c0:c1] >= 0).squeeze(1)
        if len(sel):
            qi, sel_d = plant_of[c0:c1][sel].to(dev), sel.to(dev)
            near = q_dense6[qi] + 0.5 * unit6(len(sel), DIM)
            rows[sel_d] = near / near.norm(dim=1, keepdim=True)
            near_t = q_toks6[qi] + 0.3 * unit6(len(sel), TD, DIM)
            toks[sel_d] = near_t / near_t.norm(dim=-1, keepdim=True)
        dense6[c0:c1].copy_(rows.to(torch.bfloat16))
        writer.append(toks, doc_lens6[c0:c1].numpy(), ids6[c0:c1])
    writer.finalize()
    del rows, toks
    store6 = TokenShardStore.open(work / "twostage" / "tokens")
    index6 = DenseFlatIndex.build(dense6, ids6).to_device()
    q_np = (q_dense6.cpu().numpy(), q_toks6.cpu().numpy(), q_lens6.numpy().astype(np.int32))
    save_query_token_cache(work / "qc6" / "twostage.npz", qids, *q_np)
    torch.cuda.synchronize()
    gen6_s = time.perf_counter() - t0
    check(index6._rows_per_shard < topk.TWO_LEVEL_MIN_ROWS, "two-stage index not on the single-level route")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    runs6 = run_two_stage_search(index6, store6, None, {"twostage": [(q, "") for q in qids]}, work / "ts_runs",
                                 k=100, k_dense=K_DENSE, query_block=256, cache_root=work / "qc6")
    run6_s = time.perf_counter() - t0
    path_counts["two_stage"] = dict(kernels.LAUNCHES)
    check(path_counts["two_stage"]["maxsim"] > 0, "the two-stage run did not launch kernel 6")
    check(path_counts["two_stage"]["bin_scores_transposed"] > 0,
          "the two-stage dense stage did not launch kernel 2 (transposed)")
    got6, _ = run_table(runs6["twostage"], 100, doc_int=lambda d: int(d[1:]))
    # the dense stage through the adaptive tier (kernel A on this bf16 index): the same ids
    kernels.reset_launch_counts()
    runs6a = run_two_stage_search(index6, store6, None, {"twostage": [(q, "") for q in qids]}, work / "ts_adaptive",
                                  k=100, k_dense=K_DENSE, query_block=256, cache_root=work / "qc6", approx="adaptive")
    path_counts["two_stage_adaptive"] = dict(kernels.LAUNCHES)
    check(path_counts["two_stage_adaptive"]["bin_scores_bin_major"] > 0
          and path_counts["two_stage_adaptive"]["maxsim"] > 0 and path_counts["two_stage_adaptive"]["super_select"] > 0,
          "the adaptive two-stage run missed kernel A, 6 or super_select")
    check(np.array_equal(run_table(runs6a["twostage"], 100, doc_int=lambda d: int(d[1:]))[0], got6),
          "the two-stage run with the adaptive dense stage differs from the exact one")
    # the same searcher card-resident (timed warm) and through the memmap path
    res = TwoStageSearcher(index6, store6)
    check(res.device_resident, "a 4.3 GB token store should be card-resident under the 6 GiB budget")
    res.search(*q_np, 100, k_dense=K_DENSE, query_block=256, return_docids=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, res_ids = res.search(*q_np, 100, k_dense=K_DENSE, query_block=256, return_docids=False)
    res_s = time.perf_counter() - t0
    mm = TwoStageSearcher(index6, store6, device_resident=False)
    t0 = time.perf_counter()
    _, mm_ids = mm.search(*q_np, 100, k_dense=K_DENSE, query_block=256, return_docids=False)
    mm_s = time.perf_counter() - t0
    check(bool((res_ids == got6).all()), "run_two_stage_search ids differ from a resident search")
    check(bool((mm_ids == res_ids).all()), "the memmap path's ids differ from the card-resident path's")
    # against a stable (score desc, id asc) top-100 of the plain MaxSim over the same candidates
    _, cands = index6.search(q_dense6, K_DENSE, return_docids=False, query_block=256)
    ts_eq = ts_tie = ts_bad = 0
    for i in range(0, N_QUERIES, 256):
        cand = torch.from_numpy(cands[i : i + 256]).to(dev)
        flat = cand.reshape(-1)
        dt6 = _dequant_bf16(res._tok_dev.index_select(0, flat), res._scales_dev.index_select(0, flat))
        dt6 = dt6.reshape(256, K_DENSE, TD, DIM)
        dm6 = (torch.arange(TD, device=dev)[None, :] < res._lengths_dev.index_select(0, flat)[:, None])
        dm6 = dm6.to(torch.int32).reshape(256, K_DENSE, TD)
        ps6 = msim.maxsim_scores_plain(q_toks6[i : i + 256], q_mask6[i : i + 256], dt6, dm6)
        ws6, wi6 = _merge_two_key(ps6, cand, 100)
        gid6 = torch.from_numpy(got6[i : i + 256]).to(dev)
        hit = gid6[:, :, None] == cand[:, None, :]
        check(bool(hit.any(dim=2).all()), "a reranked id is not among its dense candidates")
        gs6 = torch.gather(ps6, 1, hit.to(torch.int32).argmax(dim=2))
        eq = (gid6 == wi6).all(dim=1)
        bad = ((gs6 - ws6).abs() > TIE_TOL_MAXSIM).any(dim=1) & ~eq
        ts_eq += int(eq.sum())
        ts_bad += int(bad.sum())
        ts_tie += int((~eq & ~bad).sum())
        if i == 0:  # kernel 6 at the main shape: the first block as the path gives it
            q256, qm256, dt256, dm256 = q_toks6[:256].contiguous(), q_mask6[:256].contiguous(), dt6, dm6
        del dt6, dm6, ps6
    check(ts_bad == 0, f"{ts_bad} two-stage queries differ from the plain MaxSim top-100 beyond ties")
    qrels6 = work / "qrels6.tsv"
    qrels6.write_text("".join(f"{q}\tt{int(planted6[i])}\t1\n" for i, q in enumerate(qids)))
    cli_main(["evaluate", "--dataset", "twostage", "--run", str(runs6["twostage"]), "--qrels", str(qrels6),
              "--outdir", str(work / "eval6"), "--metrics", "MRR@10", "nDCG@10", "R@100"])
    (agg6_path,) = (work / "eval6").glob("*-agg.json")
    agg6 = json.loads(agg6_path.read_text())
    check(agg6["RR@10"] == 100.0, f"two-stage RR@10 {agg6['RR@10']}")
    say("two_stage", docs=SMALL_ROWS, tokens_per_doc=TD, token_dim=DIM, token_dtype="int8",
        token_store_gb=round(res._store_bytes() / 1e9, 2),
        queries=N_QUERIES, query_tokens=TQ, k=100, k_dense=K_DENSE, query_block=256,
        generate_and_write_s=round(gen6_s, 2), run_two_stage_search_s=round(run6_s, 2),
        resident_queries_per_s=round(N_QUERIES / res_s, 1), memmap_queries_per_s=round(N_QUERIES / mm_s, 1),
        memmap_ids_equal_resident=True, ids_equal_plain_topk=ts_eq, ids_equal_up_to_ties=ts_tie,
        tie_tol=TIE_TOL_MAXSIM, rr10=agg6["RR@10"], launches=path_counts["two_stage"],
        adaptive_dense_stage_ids_equal=True, adaptive_launches=path_counts["two_stage_adaptive"])
    k6 = msim.maxsim_scores(q256, qm256, dt256, dm256)
    p6 = msim.maxsim_scores_plain(q256, qm256, dt256, dm256)
    torch.cuda.synchronize()
    err6 = (k6 - p6).abs().max().item()
    rel6 = ((k6 - p6).abs() / p6.abs().clamp(min=1.0)).max().item()
    check(bool(((k6 - p6).abs() <= TOL_MAXSIM + TOL_MAXSIM_REL * p6.abs()).all()),
          f"6 err {err6} (relative {rel6}) at the main shape")
    qb256 = q256.to(torch.bfloat16)

    def lib_maxsim():
        s = torch.einsum("bqd,bktd->bkqt", qb256, dt256)
        s = s.masked_fill(dm256[:, :, None, :] == 0, -torch.inf).amax(dim=-1).float()
        s = torch.where(qm256[:, None, :] > 0, s, 0.0)
        return torch.where(torch.isfinite(s), s, 0.0).sum(dim=-1)

    b_ms, b_by = bound(256 * TQ * DIM * 4 + 256 * TQ * 4 + 256 * K_DENSE * TD * DIM * 2
                       + 256 * K_DENSE * TD * 4 + 256 * K_DENSE * 4, 2 * 256 * K_DENSE * TQ * TD * DIM)
    late_entries.append(dict(
        name="maxsim", route="cuda", source="codemix_dense_retrieval_torch/csrc/maxsim.cu",
        replaces="codemix_dense_retrieval_tpu/ops/maxsim.py:132", launches=None,
        max_abs_err=max(errs["maxsim"], err6), max_rel_err=rel6,
        **kernel_ms(lambda: msim.maxsim_scores(q256, qm256, dt256, dm256), 5),
        plain_ms=cuda_ms(lambda: msim.maxsim_scores_plain(q256, qm256, dt256, dm256), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib_maxsim, 3),
        shape=f"B=256 K={K_DENSE} Tq={TQ} Td={TD} d={DIM}, f32 queries, bf16 doc tokens "
              "(library: einsum in bf16)",
    ))
    del res, mm, index6, q256, qm256, dt256, dm256, k6, p6
    shutil.rmtree(work / "twostage", ignore_errors=True)
    torch.cuda.empty_cache()

    # ---------------- phase 7: kernels line ----------------
    mark("7")
    def total(name):
        return sum(c[name] for key, c in path_counts.items() if not key.startswith("bits."))

    def bin_kernel_err(run, run_plain, nv, layout, tol, label):
        """Max |kernel - plain| over the valid scores and the bin maxima at
        this shape (chunked, to bound memory); pad scores exactly NEG_INF."""
        s, bm = run()
        s2, bm2 = run_plain()
        torch.cuda.synchronize()
        if layout == "transposed":
            s, s2 = s.T, s2.T
        n_valid = int(nv.item())
        check(bool((s[:, n_valid:] == topk.NEG_INF).all()), f"{label} pad at the {layout} main shape")
        err = (bm - bm2).abs().max().item()
        for c0 in range(0, n_valid, 1 << 20):
            c1 = min(c0 + (1 << 20), n_valid)
            err = max(err, (s[:, c0:c1] - s2[:, c0:c1]).abs().max().item())
        check(err <= tol, f"{label} {layout} err {err} at the main shape")
        return err

    def kernel_a_err(q, docs, nv, bin_size, layout):
        return bin_kernel_err(
            lambda: topk.bin_scores(q, docs, nv, bin_size, layout=layout),
            lambda: topk.bin_scores_plain(q, docs, nv, bin_size, layout=layout),
            nv, layout, 1e-4, "A",
        )

    def kernel_4_err(q8, qs8, d8, ds8, nv, bin_size, layout):
        return bin_kernel_err(
            lambda: topk.bin_scores_int8(q8, qs8, d8, ds8, nv, bin_size, layout=layout),
            lambda: topk.bin_scores_int8_plain(q8, qs8, d8, ds8, nv, bin_size, layout=layout),
            nv, layout, 0.0, "kernel 4",
        )

    entries = []
    # kernel A, bin-major, at the search phase's shape
    qa256 = q05[:256].contiguous()
    docs_big, nv_big = index._docs_dev[0], index._counts_dev[0]
    nb_big = docs_big.shape[0]
    col = torch.arange(nb_big, device=dev)

    def lib_bm():
        s = torch.matmul(qa256, docs_big.T).masked_fill_(col >= nv_big, -torch.inf)
        return s.view(256, nb_big // 8, 8).amax(dim=2)

    err_main = kernel_a_err(qa256, docs_big, nv_big, 8, "bin_major")
    ms = kernel_ms(lambda: topk.bin_scores(qa256, docs_big, nv_big, 8, layout="bin_major"), 5)
    plain = cuda_ms(lambda: topk.bin_scores_plain(qa256, docs_big, nv_big, 8, layout="bin_major"), 2)
    lib = cuda_ms(lib_bm, 3)
    b_ms, b_by = bound(256 * DIM * 2 + nb_big * DIM * 2 + 256 * nb_big * 4 + 256 * nb_big // 8 * 4,
                       2 * 256 * nb_big * DIM)
    entries.append(dict(
        name="bin_scores[bin_major]", route="cuda",
        source="codemix_dense_retrieval_torch/csrc/bin_scores.cu",
        replaces="codemix_dense_retrieval_tpu/ops/topk.py:492",
        launches=total("bin_scores_bin_major"), max_abs_err=max(errs["bin_major"], err_main), **ms,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        shape=f"B=256 N={nb_big} d={DIM} G=8 f32 scores",
    ))
    # where a 256-query search block's time goes: kernel A, then the tail
    from codemix_dense_retrieval_torch.parallel.sharded_search import sharded_topk_ip

    q64 = qa256[:64].contiguous()
    ms64 = cuda_ms(lambda: topk.bin_scores(q64, docs_big, nv_big, 8, layout="bin_major"), 5)
    s_bm, b_bm = topk.bin_scores(qa256, docs_big, nv_big, 8, layout="bin_major")
    tail100 = cuda_ms(lambda: topk._topk_from_bins_two_level_bm(s_bm, b_bm, 100, 8, 8), 3)
    tail1000 = cuda_ms(lambda: topk._topk_from_bins_two_level_bm(s_bm, b_bm, 1000, 8, 8), 3)
    del s_bm, b_bm
    blk100 = cuda_ms(lambda: sharded_topk_ip(qa256, docs_big, index._counts_dev, 100), 3)
    blk1000 = cuda_ms(lambda: sharded_topk_ip(qa256, docs_big, index._counts_dev, 1000), 3)
    say("search_breakdown", block_queries=256, kernel_ms=entries[0]["ms"], kernel_ms_64_queries=ms64,
        tail_k100_ms=tail100,
        tail_k1000_ms=tail1000, sharded_topk_k100_ms=blk100, sharded_topk_k1000_ms=blk1000)
    # kernel 5 at the rescore search's shape; its yardstick is kernel A's (the
    # same PyTorch call computes these bin maxima)
    bm5 = topk.binmax_only(qa256, docs_big, nv_big, 8)
    bm5p = topk.binmax_only_plain(qa256, docs_big, nv_big, 8)
    torch.cuda.synchronize()
    err5 = (bm5 - bm5p).abs().max().item()
    check(err5 <= 1e-4, f"5 err {err5} at the main shape")
    check(bool((bm5[:, -(-N_ROWS // 8):] == topk.NEG_INF).all()), "5 pad bins at the main shape")
    del bm5, bm5p
    ms = kernel_ms(lambda: topk.binmax_only(qa256, docs_big, nv_big, 8), 5)
    plain = cuda_ms(lambda: topk.binmax_only_plain(qa256, docs_big, nv_big, 8), 2)
    b_ms, b_by = bound(256 * DIM * 2 + nb_big * DIM * 2 + 256 * nb_big // 8 * 4, 2 * 256 * nb_big * DIM)
    entries.append(dict(
        name="binmax_only", route="cuda",
        source="codemix_dense_retrieval_torch/csrc/bin_scores.cu",
        replaces="codemix_dense_retrieval_tpu/ops/topk.py:710",
        launches=total("binmax_only"), max_abs_err=max(errs["binmax_only"], err5), **ms,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=entries[0]["library_ms"],
        shape=f"B=256 N={nb_big} d={DIM} G=8 bf16, bin-major maxima only",
    ))
    del docs_big, index
    # kernel 4, bin-major, at the int8 search phase's shape
    q8_256, qs8_256 = quantize_rows(mix05[:256].contiguous())
    nv8 = index8._counts_dev[0]

    def lib_int8_bm():
        acc = torch._int_mm(q8_256, d8_big.T)
        s = acc.to(torch.float32).mul_(ds8_big).mul_(qs8_256[:, None])
        return s.masked_fill_(col >= nv8, -torch.inf).view(256, nb_big // 8, 8).amax(dim=2)

    err_main = kernel_4_err(q8_256, qs8_256, d8_big, ds8_big, nv8, 8, "bin_major")
    ms = kernel_ms(lambda: topk.bin_scores_int8(q8_256, qs8_256, d8_big, ds8_big, nv8, 8, layout="bin_major"), 5)
    plain = cuda_ms(lambda: topk.bin_scores_int8_plain(q8_256, qs8_256, d8_big, ds8_big, nv8, 8,
                                                       layout="bin_major"), 2)
    lib = cuda_ms(lib_int8_bm, 3)
    gemm_only = cuda_ms(lambda: torch._int_mm(q8_256, d8_big.T), 3)  # the yardstick's GEMM alone
    b_ms, b_by = bound(256 * DIM + 256 * 4 + nb_big * DIM + nb_big * 4 + 256 * nb_big * 4
                       + 256 * nb_big // 8 * 4, 2 * 256 * nb_big * DIM, INT8_OPS)
    entries.append(dict(
        name="bin_scores_int8[bin_major]", route="cuda",
        source="codemix_dense_retrieval_torch/csrc/bin_scores_int8.cu",
        replaces="codemix_dense_retrieval_tpu/ops/topk.py:605",
        launches=total("bin_scores_int8_bin_major"), max_abs_err=max(errs["int8_bin_major"], err_main),
        **ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib, library_gemm_ms=gemm_only,
        shape=f"B=256 N={nb_big} d={DIM} G=8 int8, f32 scores",
    ))
    del d8_big, ds8_big, index8
    # kernel A, transposed, at the CLI phase's shape
    docs_s, nv_s = small_dev._docs_dev[0], small_dev._counts_dev[0]
    ns = docs_s.shape[0]
    col_s = torch.arange(ns, device=dev)[:, None]

    def lib_tr():
        s = torch.matmul(docs_s, qa256.T).masked_fill_(col_s >= nv_s, -torch.inf)
        return s.view(ns // 16, 16, 256).amax(dim=1)

    err_main = kernel_a_err(qa256, docs_s, nv_s, 16, "transposed")
    ms = kernel_ms(lambda: topk.bin_scores(qa256, docs_s, nv_s, 16, layout="transposed"), 20)
    plain = cuda_ms(lambda: topk.bin_scores_plain(qa256, docs_s, nv_s, 16, layout="transposed"), 5)
    lib = cuda_ms(lib_tr, 20)
    b_ms, b_by = bound(256 * DIM * 2 + ns * DIM * 2 + 256 * ns * 4 + 256 * ns // 16 * 4,
                       2 * 256 * ns * DIM)
    entries.append(dict(
        name="bin_scores[transposed]", route="cuda",
        source="codemix_dense_retrieval_torch/csrc/bin_scores.cu",
        replaces="codemix_dense_retrieval_tpu/ops/topk.py:389",
        launches=total("bin_scores_transposed"), max_abs_err=max(errs["transposed"], err_main), **ms,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        shape=f"B=256 N={ns} d={DIM} G=16 f32 scores",
    ))
    # kernel 4, transposed, on the CLI phase's rows quantized
    d8_s, ds8_s = quantize_rows(docs_s)

    def lib_int8_tr():
        acc = torch._int_mm(d8_s, q8_256.T)
        s = acc.to(torch.float32).mul_(ds8_s[:, None]).mul_(qs8_256)
        return s.masked_fill_(col_s >= nv_s, -torch.inf).view(ns // 16, 16, 256).amax(dim=1)

    err_main = kernel_4_err(q8_256, qs8_256, d8_s, ds8_s, nv_s, 16, "transposed")
    ms = kernel_ms(lambda: topk.bin_scores_int8(q8_256, qs8_256, d8_s, ds8_s, nv_s, 16, layout="transposed"), 20)
    plain = cuda_ms(lambda: topk.bin_scores_int8_plain(q8_256, qs8_256, d8_s, ds8_s, nv_s, 16,
                                                       layout="transposed"), 5)
    lib = cuda_ms(lib_int8_tr, 20)
    b_ms, b_by = bound(256 * DIM + 256 * 4 + ns * DIM + ns * 4 + 256 * ns * 4 + 256 * ns // 16 * 4,
                       2 * 256 * ns * DIM, INT8_OPS)
    entries.append(dict(
        name="bin_scores_int8[transposed]", route="cuda",
        source="codemix_dense_retrieval_torch/csrc/bin_scores_int8.cu",
        replaces="codemix_dense_retrieval_tpu/ops/topk.py:605",
        launches=total("bin_scores_int8_transposed"), max_abs_err=max(errs["int8_transposed"], err_main),
        **ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        shape=f"B=256 N={ns} d={DIM} G=16 int8, f32 scores",
    ))
    # kernel B at the passage encode's shape: 32 passages, bucket 1024, 16 heads of 64
    from codemix_dense_retrieval_torch.models.tokenizer import HashTokenizer

    _, tok_mask = HashTokenizer().encode_batch(passages[:32], 1024)
    lens = torch.from_numpy(tok_mask.sum(axis=1).astype(np.int32)).to(dev)
    bsz, h, seq, dh = 32, 16, 1024, 64
    q = torch.randn(bsz, seq, h, dh, device=dev, generator=g).to(torch.bfloat16).transpose(1, 2)
    k = torch.randn(bsz, seq, h, dh, device=dev, generator=g).to(torch.bfloat16).transpose(1, 2)
    v = torch.randn(bsz, seq, h, dh, device=dev, generator=g).to(torch.bfloat16).transpose(1, 2)
    key_mask = (torch.arange(seq, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    err_main = (fa.attention_flash(q, k, v, lens).float()
                - fa.attention_flash_plain(q.float(), k.float(), v.float(), lens)).abs().max().item()
    check(err_main <= 2e-2, f"B err {err_main} at the main shape")
    ms = kernel_ms(lambda: fa.attention_flash(q, k, v, lens), 20)
    plain = cuda_ms(lambda: fa.attention_flash_plain(q, k, v, lens), 3)
    lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=key_mask), 20)
    b_ms, b_by = bound(4 * bsz * h * seq * dh * 2, 4 * h * seq * dh * int(lens.sum().item()))
    entries.append(dict(
        name="flash_attention", route="cuda",
        source="codemix_dense_retrieval_torch/csrc/flash_attention.cu",
        replaces="codemix_dense_retrieval_tpu/ops/flash_attention.py:249",
        launches=total("flash_attention"), max_abs_err=max(errs["flash_bf16"], err_main), **ms,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        shape=f"B={bsz} H={h} S={seq} dh={dh} bf16 mean_len={lens.float().mean().item():.1f}",
        **packed_b,
    ))
    entries[-1]["max_abs_err"] = max(entries[-1]["max_abs_err"], err_packed)
    del q, k, v, small_dev, docs_s, d8_s, ds8_s, col_s
    torch.cuda.empty_cache()

    # ---------------- phase 8: the bilingual hub at full size ----------------
    mark("8")
    from codemix_dense_retrieval_torch.config import format_alpha
    from codemix_dense_retrieval_torch.pipeline.bilingual import (
        run_bilingual_vector_mix,
        run_bilingual_vector_mix_fused,
    )

    # language 2, parallel to the phase-5 rows: row i is normalize(row_i +
    # 0.3 u_i), u_i a random unit vector, under the same docid
    t0 = time.perf_counter()
    host2 = torch.empty((N_ROWS, DIM), dtype=torch.bfloat16)
    gh = torch.Generator(device=dev).manual_seed(SEED + 5)
    for c0 in range(0, N_ROWS, 1 << 20):
        c1 = min(c0 + (1 << 20), N_ROWS)
        x = host[c0:c1].to(dev).float()
        u = torch.randn(x.shape, device=dev, generator=gh)
        y = x + 0.3 * u / u.norm(dim=1, keepdim=True)
        host2[c0:c1].copy_((y / y.norm(dim=1, keepdim=True)).to(torch.bfloat16))
    del x, u, y
    hub = DenseFlatIndex.merged([DenseFlatIndex.build(host, docids), DenseFlatIndex.build(host2, docids)],
                                lang_tags=["l1", "l2"])
    hub_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hub.to_device()
    torch.cuda.synchronize()
    hub_upload_s = time.perf_counter() - t0
    check(hub.count == 2 * N_ROWS and hub._rows_per_shard == -(-2 * N_ROWS // 1024) * 1024,
          f"hub rows {hub.count} / {hub._rows_per_shard}")
    # both runs ask for the CLI's 1024-query block, which their route (kernel
    # 5's bin maxima, no score store) keeps whole; kernel A's check below
    # takes the block a score store leaves room for (256 on an 80 GB card)
    from codemix_dense_retrieval_torch.parallel.sharded_search import fit_query_block

    hub_block = min(fit_query_block(1024, N_QUERIES, hub._rows_per_shard, dev), N_QUERIES)
    run_block = min(fit_query_block(1024, N_QUERIES, hub._rows_per_shard, hub._docs_dev), N_QUERIES)
    out_hub = work / "hub"
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hub_unfused = run_bilingual_vector_mix(hub, qids, qa, qb, ALPHAS, out_hub / "unfused", k=500, query_block=1024)
    t_hub = time.perf_counter() - t0
    path_counts["hub_unfused"] = dict(kernels.LAUNCHES)
    check(path_counts["hub_unfused"]["binmax_only"] > 0 and path_counts["hub_unfused"]["cover_rescore"] > 0
          and path_counts["hub_unfused"]["super_select"] > 0,
          "the hub run did not launch kernel 5, cover_rescore and super_select")
    hub_qrels = {q: {str(int(planted[i])): 1} for i, q in enumerate(qids)}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hub_fused, hub_metrics = run_bilingual_vector_mix_fused(
        hub, qids, qa, qb, ALPHAS, out_hub / "fused", k=500, qrels=hub_qrels, query_block=1024)
    t_hub_fused = time.perf_counter() - t0
    path_counts["hub_fused"] = dict(kernels.LAUNCHES)
    check(path_counts["hub_fused"]["binmax_only"] > 0 and path_counts["hub_fused"]["cover_rescore"] > 0
          and path_counts["hub_fused"]["super_select"] > 0,
          "the fused hub run did not launch kernel 5, cover_rescore and super_select")

    def trec_rows(path):
        rows = {}
        with open(path) as fh:
            for line in fh:
                f = line.split()
                rows.setdefault(f[0], []).append((f[2], f[4]))
        return rows

    # per query the unfused collapse (the bases whose best row is in the raw
    # top-500, at their true max) is a prefix of the fused run (2k raw depth,
    # always 500 bases); order is free only among equal printed scores
    # (the checks of this phase run after its line is printed)
    tie_reordered, unfused_len_min, not_prefix = 0, 500, []
    for a in ALPHAS:
        u_rows, f_rows = trec_rows(hub_unfused[a]), trec_rows(hub_fused[a])
        check(len(f_rows) == N_QUERIES and len(u_rows) == N_QUERIES, f"hub runs cover the queries, alpha={a}")
        for q in qids:
            ur, fr = u_rows[q], f_rows[q]
            unfused_len_min = min(unfused_len_min, len(ur))
            if len(fr) != 500 or len(ur) > 500 or [sc for _, sc in ur] != [sc for _, sc in fr[: len(ur)]]:
                not_prefix.append((a, q))
            elif [d for d, _ in ur] != [d for d, _ in fr[: len(ur)]]:
                # the order may differ only among equal printed scores
                if any(not {d for d, x in ur if x == sc} <= {d for d, x in fr if x == sc} for sc in {x for _, x in ur}):
                    not_prefix.append((a, q))
                tie_reordered += 1
    # kernel A against its plain version at the hub's block shape (one block
    # of the alpha = .5 mix, as the sweep made it): the score store passes
    # 2^32 elements (offsets b * N + n of queries b >= 243 at B = 256). Every
    # query of the block, the plain version 32 queries at a time; scores and
    # bin maxima within 1e-4, pad scores and pad bins exactly NEG_INF
    mixh = mix_and_renorm(qa_t.to(dev), qb_t.to(dev), 0.5)
    qblk = mixh[:hub_block].to(torch.bfloat16).contiguous()
    nv_h, nb_h = hub._counts_dev[0], hub._docs_dev[0].shape[0]
    s_h, bm_h = topk.bin_scores(qblk, hub._docs_dev[0], nv_h, 8, layout="bin_major")
    torch.cuda.synchronize()
    check(bool((s_h[:, hub.count:] == topk.NEG_INF).all()), "A pad scores at the hub's shape")
    check(bool((bm_h[:, -(-hub.count // 8):] == topk.NEG_INF).all()), "A pad bins at the hub's shape")
    err_hub = 0.0
    for r0 in range(0, hub_block, 32):
        s2, bm2 = topk.bin_scores_plain(qblk[r0 : r0 + 32], hub._docs_dev[0], nv_h, 8, layout="bin_major")
        err_hub = max(err_hub, (bm_h[r0 : r0 + 32] - bm2).abs().max().item())
        for c0 in range(0, hub.count, 1 << 22):
            c1 = min(c0 + (1 << 22), hub.count)
            err_hub = max(err_hub, (s_h[r0 : r0 + 32, c0:c1] - s2[:, c0:c1]).abs().max().item())
        del s2, bm2
    check(err_hub <= 1e-4, f"A err {err_hub} at the hub's shape B={hub_block} N={nb_h}")
    entries[0].update(max_abs_err=max(entries[0]["max_abs_err"], err_hub),
                      hub_shape=f"B={hub_block} N={nb_h} d={DIM} G=8 f32 scores", hub_max_abs_err=err_hub)
    # the fused ids of 64 queries: a stable (score desc, base asc) top-500 of
    # each base's max over its two rows, from kernel A's own scores
    base_max = torch.maximum(s_h[:64, :N_ROWS], s_h[:64, N_ROWS : 2 * N_ROWS])
    del s_h, bm_h
    thr = torch.topk(base_max, 500, dim=1).values[:, -1]
    own_h = []
    for r in range(64):
        cand = torch.nonzero(base_max[r] >= thr[r]).squeeze(1)
        order = torch.sort(base_max[r, cand], descending=True, stable=True).indices[:500]
        own_h.append(cand[order])
    own_h = torch.stack(own_h).cpu().numpy()
    del base_max
    f05 = trec_rows(hub_fused[0.5])
    own_rows_equal = int((own_h == np.array([[int(d) for d, _ in f05[q]] for q in qids[:64]])).all(axis=1).sum())
    # the device metrics x100 against evaluate on the fused runs
    qrels_hub = work / "qrels_hub.tsv"
    qrels_hub.write_text("".join(f"{q}\t{int(planted[i])}\t1\n" for i, q in enumerate(qids)))
    metric_gap, host_metrics = 0.0, {}
    for a in ALPHAS:
        label = format_alpha(a)
        cli_main(["evaluate", "--dataset", "hub", "--run", str(hub_fused[a]), "--qrels", str(qrels_hub),
                  "--outdir", str(work / "eval_hub" / label), "--metrics", "MRR@10", "nDCG@10", "R@100"])
        (agg_h_path,) = (work / "eval_hub" / label).glob("*-agg.json")
        agg_h = json.loads(agg_h_path.read_text())
        host_metrics[label] = {m: agg_h[m] for m in ("RR@10", "nDCG@10", "R@100")}
        for m in ("RR@10", "nDCG@10", "R@100"):
            metric_gap = max(metric_gap, abs(agg_h[m] - hub_metrics[label][m]))
    # kernel A and one search block at the hub's shape
    hub_kernel = kernel_ms(lambda: topk.bin_scores(qblk, hub._docs_dev[0], nv_h, 8, layout="bin_major"), 3)
    hub_blk500 = cuda_ms(lambda: sharded_topk_ip(qblk, hub._docs_dev[0], hub._counts_dev, 500), 3)
    hub_blk1000 = cuda_ms(lambda: sharded_topk_ip(qblk, hub._docs_dev[0], hub._counts_dev, 1000), 3)
    say("hub", rows=hub.count, rows_padded=hub._rows_per_shard, dim=DIM, dtype="bfloat16", langs=["l1", "l2"],
        card_gb=round(hub._docs_dev[0].numel() * 2 / 1e9, 2), build_s=round(hub_build_s, 2),
        upload_s=round(hub_upload_s, 2), alphas=len(ALPHAS), k=500, query_block_asked=1024,
        query_block=run_block, kernel_a_block=hub_block, kernel_a_max_abs_err=err_hub,
        unfused_queries_per_s=round(len(ALPHAS) * N_QUERIES / t_hub, 1),
        fused_queries_per_s=round(len(ALPHAS) * N_QUERIES / t_hub_fused, 1),
        unfused_min_bases=unfused_len_min, prefix_violations=len(not_prefix),
        prefix_queries_reordered_within_ties=tie_reordered, own_scores_collapsed_ids_equal_of_64=own_rows_equal,
        metric_gap_vs_evaluate=metric_gap,
        metrics={format_alpha(a): {m: hub_metrics[format_alpha(a)][m] for m in ("RR@10", "nDCG@10", "R@100")}
                 for a in ALPHAS},
        evaluate_metrics=host_metrics,
        kernel_a_ms=hub_kernel, block_k500_ms=hub_blk500, block_k1000_ms=hub_blk1000,
        launches={"unfused": path_counts["hub_unfused"], "fused": path_counts["hub_fused"]})
    check(not not_prefix, f"hub: the unfused run is not a prefix of the fused one (up to ties) for "
                          f"{len(not_prefix)} (alpha, query) pairs, e.g. {not_prefix[:3]}")
    check(own_rows_equal == 64, f"fused hub ids differ from a stable collapsed top-500 of kernel A's own "
                                f"scores for {64 - own_rows_equal} of 64 queries")
    check(metric_gap <= 1e-4, f"hub device metrics x100 vs evaluate: gap {metric_gap}")
    check(host_metrics["0.5"]["RR@10"] == 100.0 and hub_metrics["0.5"]["RR@10"] == 100.0,
          f"hub RR@10 at alpha=.5: evaluate {host_metrics['0.5']['RR@10']}, device {hub_metrics['0.5']['RR@10']}")
    del hub, host2, mixh, qblk
    torch.cuda.empty_cache()

    # ---------------- phase 9: serving ----------------
    mark("9")
    from concurrent.futures import ThreadPoolExecutor

    from codemix_dense_retrieval_torch.serving import SearchService, make_server

    t9 = time.perf_counter()

    class Recorder:
        """The phase-4 encoder behind a service, keeping each query batch it
        embeds (texts, dense rows, token blocks) so that replies can be
        searched again directly while the service is idle."""

        def __init__(self, inner):
            self.inner, self.log, self.tok_log, self.encode_s = inner, [], [], 0.0

        def encode_queries(self, texts, batch_size=64):
            t0 = time.perf_counter()
            q = self.inner.encode_queries(texts, batch_size=batch_size)
            self.encode_s += time.perf_counter() - t0
            self.log.append((list(texts), q))
            return q

        def encode_queries_tokens(self, texts, batch_size=64):
            t, ln = self.inner.encode_queries_tokens(texts, batch_size=batch_size)
            self.tok_log.append((list(texts), t, ln))
            return t, ln

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def rows(self, texts):
            """The dense rows the service searched for ``texts`` (each text
            embedded once since the log was cleared)."""
            got = {}
            for ts, q in self.log:
                for t, row in zip(ts, q):
                    check(t not in got, f"text embedded twice in one window: {t[:40]!r}")
                    got[t] = row
            return np.stack([got[t] for t in texts])

    class TimedIndex:
        """The index behind the dense service, with its searches' seconds
        (the consumer's card work besides the encode)."""

        def __init__(self, inner):
            self.inner, self.search_s, self.searches = inner, 0.0, 0

        def search(self, *args, **kw):
            t0 = time.perf_counter()
            out = self.inner.search(*args, **kw)
            self.search_s += time.perf_counter() - t0
            self.searches += 1
            return out

        def __getattr__(self, name):
            return getattr(self.inner, name)

    serve_counts = {}

    @contextlib.contextmanager
    def serving(index, label, **kw):
        """SearchService + make_server on 127.0.0.1, an ephemeral port, a
        server thread; launches counted from start to stop under ``label``.
        Stops both and fails the run if the consumer recorded an error."""
        rec = Recorder(enc)
        svc = SearchService(rec, index, **kw)
        srv = make_server(svc, host="127.0.0.1", port=0, info={"model": "BAAI/bge-m3", "docs": index.count})
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        kernels.reset_launch_counts()
        try:
            yield svc, srv.server_address[1], rec
        finally:
            serve_counts[label] = dict(kernels.LAUNCHES)
            srv.shutdown()
            srv.server_close()
            svc.close()
            th.join(timeout=30)
        health = svc.stats.snapshot()
        check(health["errors"] == 0, f"serving {label}: {health['errors']} failed batches")

    def call(port, path, body=None, expect=200):
        """One HTTP request with its own timeout; fails the run on any status
        but ``expect``. Returns (reply, seconds)."""
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        t0 = time.perf_counter()
        try:
            if body is None:
                conn.request("GET", path)
            else:
                conn.request("POST", path, body=json.dumps(body), headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = json.loads(resp.read())
        finally:
            conn.close()
        check(resp.status == expect, f"{path}: status {resp.status}, not {expect}: {data}")
        return data, time.perf_counter() - t0

    def uncounted(fn, *args, **kw):
        """A direct search to compare replies with, run while the service is
        idle; its launches are kept out of the window."""
        saved = dict(kernels.LAUNCHES)
        try:
            return fn(*args, **kw)
        finally:
            kernels.LAUNCHES.update(saved)

    def same_up_to_ties(got, want_ids, want_scores, label):
        """Served ids (rows of docid strings) against an exact search of the
        same embeddings at a depth >= theirs: equal, or swapped only where
        the exact scores lie within TIE_TOL (sketch-certified rows rank by the
        rescore's products). Returns the rows that differ within ties."""
        ties = 0
        for g, wi, ws in zip(got, want_ids, want_scores):
            w = [str(x) for x in wi[: len(g)]]
            if g == w:
                continue
            pos = {str(d): j for j, d in enumerate(wi)}
            check(all(d in pos and abs(ws[pos[d]] - ws[j]) <= TIE_TOL for j, d in enumerate(g)),
                  f"{label}: served ids differ from exact search beyond ties: {g[:5]} vs {w[:5]}")
            ties += 1
        return ties

    def reply_ids(results):
        return [[h["docid"] for h in (r["hits"] if isinstance(r, dict) else r)] for r in results]

    def reply_scores(results):
        return [[h["score"] for h in (r["hits"] if isinstance(r, dict) else r)] for r in results]

    # 9a. dense serving over the phase-5 rows, uploaded anew
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index9 = DenseFlatIndex.build(host, docids).to_device()
    torch.cuda.synchronize()
    upload9_s = time.perf_counter() - t0
    cap9 = index9._rows_per_shard
    singles = [(t, 10) for t in texts_a]  # 512 single-query requests at k = 10
    bigs = [(texts_b[i * 64 : (i + 1) * 64], (10, 100, 1000)[i % 3]) for i in range(8)]  # 8 x 64 queries
    timed9 = TimedIndex(index9)
    with serving(timed9, "serve_dense", max_batch=256, max_wait_s=0.005, max_k=1000) as (svc, port, rec):
        warm = svc.warmup()
        health0, _ = call(port, "/healthz")
        for bad in ({"queries": []}, {"queries": ["x"], "k": 5000}):
            call(port, "/search", bad, expect=400)
        call(port, "/add", {"docs": []}, expect=400)
        # mixed traffic: the 8 batch requests spread among the singles
        jobs = [([t], k) for t, k in singles]
        for i, job in enumerate(bigs):
            jobs.insert(i * 65 + 32, job)
        rec.log.clear()
        stats0 = svc.stats.snapshot()
        rec.encode_s = timed9.search_s = timed9.searches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=64) as pool:
            futs = [pool.submit(call, port, "/search", {"queries": q, "k": k}) for q, k in jobs]
            done = [f.result(timeout=600) for f in futs]
        traffic_s = time.perf_counter() - t0
        stats1 = svc.stats.snapshot()
        consumer = {"encode_s": rec.encode_s, "search_s": timed9.search_s, "searches": timed9.searches}
        # the same encode with the service idle: 57 queries, the traffic's mean batch
        idle = []
        for _ in range(6):
            t0 = time.perf_counter()
            enc.encode_queries(texts_a[:57], batch_size=64)
            idle.append(time.perf_counter() - t0)
        consumer["encode_idle_ms_57_queries"] = float(np.median(idle[1:]) * 1e3)
        # served ids and scores equal one direct search of the same
        # embeddings (the service idle: its futures have all resolved)
        all_texts = [t for q, _ in jobs for t in q]
        direct_s, direct_d = uncounted(index9.search, rec.rows(all_texts), 1000, query_block=256)
        off = 0
        for (q, k), (reply, _) in zip(jobs, done):
            rows = slice(off, off + len(q))
            check(reply_ids(reply["results"]) == [[str(x) for x in row[:k]] for row in direct_d[rows]],
                  f"served ids differ from direct search at k={k}")
            check(reply_scores(reply["results"]) == [[float(x) for x in row[:k]] for row in direct_s[rows]],
                  f"served scores differ from direct search at k={k}")
            off += len(q)
        lat_single = np.array([s for (q, _), (_, s) in zip(jobs, done) if len(q) == 1])
        lat_big = np.array([s for (q, _), (_, s) in zip(jobs, done) if len(q) > 1])
        # what the batch bucket costs: a search of 129 queries against the
        # same 129 zero-padded to 256 (the service's bucket), idle service
        q129 = rec.rows(all_texts)[:129]
        q256 = np.concatenate([q129, np.zeros((127, DIM), np.float32)])
        bucket_ms = {}
        for kk in (10, 1000):
            for name, qq in (("b129", q129), ("b256_padded", q256), ("b256_padded_again", q256), ("b129_again", q129)):
                uncounted(index9.search, qq, kk)
                t0 = time.perf_counter()
                for _ in range(3):
                    uncounted(index9.search, qq, kk)
                bucket_ms[f"k{kk}_{name}"] = (time.perf_counter() - t0) / 3 * 1e3
        # the reference block, then /add (in the capacity: the query texts as
        # documents), /add that grows (1,024 long passages: kernel B), /search,
        # /remove, /search
        probe = texts_a[:256]
        before, _ = call(port, "/search", {"queries": probe, "k": 10})
        qdocs = [{"docid": f"qdoc{i}", "text": t} for i, t in enumerate(probe)]
        add1, add1_s = call(port, "/add", {"docs": qdocs})
        check(add1["results"] == {"added": 256, "count": N_ROWS + 256} and index9._rows_per_shard == cap9,
              f"in-capacity add: {add1['results']}, rows {index9._rows_per_shard}")
        long_docs = [{"docid": f"long{i}", "text": sentence("s", 600, 1000, 50_000)} for i in range(1024)]
        flash0 = kernels.LAUNCHES["flash_attention"]
        add2_s = []
        for c0 in range(0, 1024, 256):
            r, sec = call(port, "/add", {"docs": long_docs[c0 : c0 + 256]})
            add2_s.append(sec)
        check(r["results"]["count"] == N_ROWS + 1280, f"grow adds: {r['results']}")
        check(kernels.LAUNCHES["flash_attention"] > flash0, "the long-passage adds did not launch kernel B")
        grows = index9.mutation_stats["grows"]
        check(len(grows) == 1 and grows[0]["from_rows"] == cap9 and index9._rows_per_shard > cap9,
              f"the grow step: {grows}")
        rec.log.clear()
        after, _ = call(port, "/search", {"queries": probe, "k": 10})
        top1 = [row[0] for row in reply_ids(after["results"])]
        check(top1 == [f"qdoc{i}" for i in range(256)],
              f"added query documents not at rank 1: {sum(a != f'qdoc{i}' for i, a in enumerate(top1))} of 256")
        _, direct_after = uncounted(index9.search, rec.rows(probe), 10)
        check(reply_ids(after["results"]) == [[str(x) for x in row] for row in direct_after],
              "served ids after the grow differ from direct search")
        rm, rm_s = call(port, "/remove", {"docids": [d["docid"] for d in qdocs + long_docs] + ["never-there"]})
        check(rm["results"] == {"removed": 1280, "count": N_ROWS}, f"remove: {rm['results']}")
        again, _ = call(port, "/search", {"queries": probe, "k": 10})
        check(again["results"] == before["results"], "after /remove the replies differ from those before the adds")
        health1, _ = call(port, "/healthz")
        check(health1["stats"]["errors"] == 0, f"/healthz errors {health1['stats']}")
    peak9 = torch.cuda.max_memory_allocated()
    check(serve_counts["serve_dense"]["binmax_only"] > 0 and serve_counts["serve_dense"]["cover_rescore"] > 0
          and serve_counts["serve_dense"]["super_select"] > 0,
          "dense serving did not launch kernel 5, cover_rescore and super_select")
    n_traffic = sum(len(q) for q, _ in jobs)
    batches = stats1["batches"] - stats0["batches"]
    say("serve", smi=smi, rows=N_ROWS, rows_padded=cap9, upload_s=round(upload9_s, 2), max_batch=256,
        max_wait_ms=5, warmup=warm, healthz_docs=health0["docs"],
        traffic={"requests": len(jobs), "single_requests": len(singles), "batch_requests": len(bigs),
                 "queries": n_traffic, "client_threads": 64, "seconds": round(traffic_s, 3)},
        queries_per_s=round(n_traffic / traffic_s, 1),
        latency_ms={"single_p50": float(np.percentile(lat_single, 50) * 1e3),
                    "single_p99": float(np.percentile(lat_single, 99) * 1e3),
                    "batch64_p50": float(np.percentile(lat_big, 50) * 1e3),
                    "batch64_p99": float(np.percentile(lat_big, 99) * 1e3)},
        batches=batches, mean_coalesced_batch=(stats1["batched_queries"] - stats0["batched_queries"]) / batches,
        consumer_in_traffic=consumer, batch_bucket_search_ms=bucket_ms,
        served_equal_direct_search=True, add_in_capacity_s=round(add1_s, 3),
        add_grow_request_s=[round(x, 3) for x in add2_s], grow=grows[0],
        row_of_s=round(index9.mutation_stats["row_of_s"], 3), rows_after_grow=index9._rows_per_shard,
        remove_s=round(rm_s, 3), added_at_rank1=256, after_remove_equal_before=True,
        card_peak_gb=round(peak9 / 1e9, 2), stats=health1["stats"], launches=serve_counts["serve_dense"])
    del index9, timed9, direct_s, direct_d, direct_after, long_docs
    torch.cuda.empty_cache()

    # 9b. the small stores: the sketch tier, two-stage, int8, snapshots
    probe = texts_a[:256]
    small9 = DenseFlatIndex.load(work / "small").to_device()
    small9.enable_sketch(sketch_dim=128)
    with serving(small9, "serve_exact") as (svc, port, rec):
        exact9, _ = call(port, "/search", {"queries": probe, "k": 10})
        _, want = uncounted(small9.search, rec.rows(probe), 10)
        check(reply_ids(exact9["results"]) == [[str(x) for x in row] for row in want],
              "exact serving over the small store differs from direct search")
    grt_ties = 0
    with serving(small9, "serve_guaranteed", approx="guaranteed") as (svc, port, rec):
        for step in ("before", "after"):
            if step == "after":
                call(port, "/add", {"docs": [{"docid": f"sq{i}", "text": t} for i, t in enumerate(probe[:64])]})
            rec.log.clear()
            grt, _ = call(port, "/search", {"queries": probe, "k": 10})
            check(all(r["certified"] for r in grt["results"]), "a guaranteed reply row is not certified")
            want_s, want = uncounted(small9.search, rec.rows(probe), 20)
            grt_ties += same_up_to_ties(reply_ids(grt["results"]), want, want_s, f"guaranteed serving, {step} the add")
        check([r[0] for r in reply_ids(grt["results"])[:64]] == [f"sq{i}" for i in range(64)],
              "added documents not at rank 1 (guaranteed)")
    small_rows = small9._rows_per_shard
    fast_cert, fast_ties = [], 0
    with serving(small9, "serve_fast", approx="fast") as (svc, port, rec):
        for step in ("added", "removed"):
            if step == "removed":
                call(port, "/remove", {"docids": [f"sq{i}" for i in range(64)]})
            rec.log.clear()
            fast, _ = call(port, "/search", {"queries": probe, "k": 1})
            want_s, want = uncounted(small9.search, rec.rows(probe), 20)
            cert = [r["certified"] for r in fast["results"]]
            check(all(isinstance(c, bool) for c in cert), "fast replies carry no certified flag")
            rows = [i for i, c in enumerate(cert) if c]
            fast_ties += same_up_to_ties([reply_ids(fast["results"])[i] for i in rows], want[rows], want_s[rows],
                                         f"certified fast rows, {step}")
            fast_cert.append(len(rows))
    check(fast_cert[0] > 0, "no fast reply certified at k = 1 with the query documents added")
    del small9

    # two-stage over the encode-corpus int8 store and its token store, with
    # headroom for the adds (card-resident blocks, kernels 4 and 6)
    from codemix_dense_retrieval_torch.pipeline.rerank import TwoStageSearcher

    ts9 = TwoStageSearcher(DenseFlatIndex.load(work / "corpus" / "xx").to_device(pad_multiple=4096),
                           TokenShardStore.open(work / "corpus" / "xx" / "tokens"))
    check(ts9.device_resident, "the encode-corpus token store is not card-resident")

    def two_stage_equal(svc_rec, reply, label):
        texts_, q = svc_rec.log[-1]
        _, qt, ql = svc_rec.tok_log[-1]
        check(texts_ == probe, f"two-stage {label}: the recorded batch is not the request")
        sc, ids = uncounted(ts9.search, q, qt, ql, 100, k_dense=K_DENSE)
        check(reply_ids(reply["results"]) == [[str(x) for x in row] for row in ids]
              and reply_scores(reply["results"]) == [[float(x) for x in row] for row in sc],
              f"two-stage serving {label} differs from a direct TwoStageSearcher.search")

    with serving(ts9, "serve_two_stage", index_search_kwargs={"k_dense": K_DENSE}) as (svc, port, rec):
        r0, _ = call(port, "/search", {"queries": probe, "k": 100})
        two_stage_equal(rec, r0, "before the add")
        call(port, "/add", {"docs": [{"docid": f"tq{i}", "text": t} for i, t in enumerate(probe[:64])]})
        r1, _ = call(port, "/search", {"queries": probe, "k": 100})
        two_stage_equal(rec, r1, "after the add")
        check([r[0] for r in reply_ids(r1["results"])[:64]] == [f"tq{i}" for i in range(64)],
              "added documents not at rank 1 (two-stage)")
        n0 = ts9.count
        chain = ["tq62", str(ts9.index.docids[3]), str(ts9.index.docids[0]), "tq5", "ghost"]
        rm, _ = call(port, "/remove", {"docids": chain})
        check(rm["results"]["removed"] == 4 and ts9.count == n0 - 4, f"two-stage remove {rm['results']}")
        swaps = ts9.index.last_swaps
        check(swaps[:2] == [(n0 - 1, n0 - 2), (n0 - 2, 3)], f"no swap chain in {swaps}")
        r2, _ = call(port, "/search", {"queries": probe, "k": 100})
        two_stage_equal(rec, r2, "after the remove")
    del ts9

    # an int8 store: /add (grows), /remove, the exact int8 top-k; /save, /reload.
    # First the card's quantizer, which /add and to_store run: the host
    # quantizer's bytes, and quantize(dequantize(q, s)) == (q, s) on the card
    from codemix_dense_retrieval_torch.ops.quant import dequantize, quantize_rows_np

    xq = torch.randn(1 << 16, DIM, device=dev, generator=gi)
    xq *= torch.exp2(torch.randint(-40, 40, (1 << 16, 1), device=dev, generator=gi).float())
    xq[:4] = 0.0
    cq, cs = quantize_rows(xq)
    hq, hs = quantize_rows_np(xq.cpu().numpy())
    rq, rs = quantize_rows(dequantize(cq, cs))
    check(np.array_equal(cq.cpu().numpy(), hq) and np.array_equal(cs.cpu().numpy(), hs),
          "the card's quantize_rows differs from the host quantizer")
    check(torch.equal(rq, cq) and torch.equal(rs, cs), "quantize(dequantize(q, s)) != (q, s) on the card")
    del xq, cq, cs, rq, rs
    i8 = DenseFlatIndex.load(work / "corpus" / "xx").to_device()

    def int8_topk_ids(rows, k):
        """Docids of the exact int8 top-k of the live rows (plain scores)."""
        n = i8.count
        q8, qs8 = quantize_rows(torch.from_numpy(rows).to(dev))
        sc = int8_ip_scores(q8, qs8, i8._docs_dev[0][:n], i8.search_kwargs["doc_scales"][0][:n])
        return [[str(i8.docids[j]) for j in row] for row in topk._stable_topk(sc, k)[1].cpu().numpy()]

    snap_root = work / "snapshots"
    snap_root.mkdir()
    with serving(i8, "serve_int8", snapshot_root=str(snap_root)) as (svc, port, rec):
        call(port, "/add", {"docs": [{"docid": f"iq{i}", "text": t} for i, t in enumerate(probe[:64])]})
        check(i8.mutation_stats["grows"], "the int8 add did not grow the 2,048-row store")
        for step in ("add", "remove"):
            if step == "remove":
                call(port, "/remove", {"docids": [f"iq{i}" for i in range(0, 64, 2)] + [str(i8.docids[7])]})
            rec.log.clear()
            r8, _ = call(port, "/search", {"queries": probe, "k": 100})
            check(reply_ids(r8["results"]) == uncounted(int8_topk_ids, rec.rows(probe), 100),
                  f"int8 serving after /{step} differs from the exact int8 top-k")
        saved, _ = call(port, "/save", {"dir": "snap"})
        check(saved["results"]["count"] == i8.count, f"/save {saved['results']}")
        call(port, "/save", {"dir": "../outside"}, expect=400)
        reloaded, _ = call(port, "/reload", {"dir": "snap"})
        check(reloaded["results"] == {"reloaded": str((snap_root / "snap").resolve()), "count": i8.count},
              f"/reload {reloaded['results']}")
        check(svc.index is not i8 and svc.index.device == i8.device, "/reload did not swap the index")
        r9, _ = call(port, "/search", {"queries": probe, "k": 100})
        check(reply_ids(r9["results"]) == reply_ids(r8["results"]), "ids changed across /save and /reload")
    del i8
    for label, kname in (("serve_exact", "bin_scores_transposed"), ("serve_guaranteed", "binub"),
                         ("serve_fast", "binub"), ("serve_two_stage", "maxsim"),
                         ("serve_two_stage", "bin_scores_int8_transposed"),
                         ("serve_int8", "bin_scores_int8_transposed")):
        check(serve_counts[label][kname] > 0, f"{label} did not launch {kname}")
    path_counts.update(serve_counts)
    say("serve_small", smi=smi, store_rows=SMALL_ROWS, rows_after_add=small_rows,
        guaranteed_equal_exact=True, guaranteed_rows_swapped_within_ties=grt_ties,
        fast_k1_certified={"with_added_docs": fast_cert[0], "after_remove": fast_cert[1]},
        fast_certified_equal_exact=True, fast_rows_swapped_within_ties=fast_ties,
        two_stage={"docs": 2048, "k": 100, "k_dense": K_DENSE, "swap_chain": swaps[:2], "equal_direct": True},
        quantizer_card_equals_host=True, int8_equal_exact_topk=True, save_reload_ids_equal=True,
        launches={k: v for k, v in serve_counts.items() if k != "serve_dense"},
        phase_s=round(time.perf_counter() - t9, 2))
    del enc

    # ---------------- phase 10: store dtypes and encoder families ----------------
    mark("10")
    t10 = time.perf_counter()
    del host  # phase 10 makes rows of its own, with full f32 mantissas
    gc.collect()  # what earlier phases left in reference cycles, before 10c's 36 GB
    torch.cuda.empty_cache()
    card_gb_10 = torch.cuda.memory_allocated() / 1e9
    from codemix_dense_retrieval_torch.models.gte import GTEConfig, GTEEncoder
    from codemix_dense_retrieval_torch.models.qwen3 import Qwen3Config, Qwen3Encoder
    from codemix_dense_retrieval_torch.models.registry import load_encoder
    from codemix_dense_retrieval_torch.models.xlmr import init_random_

    # 10a. Qwen3-Embedding-0.6B at its published widths (28 layers, d=1024,
    # 16 query heads over 8 KV heads of 128, FFN 3072, vocab 151,669), random
    # init on the card from a seeded generator, written as an HF-format
    # directory (config.json + pytorch_model.bin: the card's machine has no
    # safetensors) and loaded through the registry (bf16, kernel B causal)
    qcfg = Qwen3Config.embedding_0p6b()
    with torch.device("meta"):
        qmodel = Qwen3Encoder(qcfg)
    qmodel = qmodel.to_empty(device=dev)
    init_random_(qmodel, torch.Generator(device=dev).manual_seed(SEED + 10))
    qdir = work / "qwen3"
    qdir.mkdir()
    (qdir / "config.json").write_text(json.dumps({
        "model_type": "qwen3", "vocab_size": qcfg.vocab_size, "hidden_size": qcfg.hidden_size,
        "num_hidden_layers": qcfg.num_layers, "num_attention_heads": qcfg.num_heads,
        "num_key_value_heads": qcfg.num_kv_heads, "head_dim": qcfg.head_dim,
        "intermediate_size": qcfg.intermediate_size, "rms_norm_eps": qcfg.rms_norm_eps,
        "rope_theta": qcfg.rope_theta, "max_position_embeddings": qcfg.max_position_embeddings,
        "tie_word_embeddings": True}))
    torch.save({f"model.{k}": v.to(torch.bfloat16).cpu() for k, v in qmodel.state_dict().items()},
               qdir / "pytorch_model.bin")
    del qmodel
    qwen = "Qwen/Qwen3-Embedding-0.6B"
    t0 = time.perf_counter()
    qenc = load_encoder(qwen, str(qdir))
    qload_s = time.perf_counter() - t0
    check(type(qenc.model).__name__ == "Qwen3Encoder" and qenc.cfg.use_flash
          and qenc.cfg.dtype == torch.bfloat16 and qenc.cfg.num_kv_heads == 8, "Qwen3 load")
    qenc.length_buckets = buckets  # to the 1024 bucket
    g10k = torch.Generator(device=dev).manual_seed(SEED + 13)  # kernel operands of phase 10
    corpus_texts = [line.split("\t", 1)[1] for line in corpus_tsv.read_text().splitlines()]
    qenc.encode_queries(texts_a[:8])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    qq = qenc.encode_queries(texts_a[:N_QWEN_QUERIES], batch_size=128)
    qq_s = time.perf_counter() - t0
    path_counts["qwen3_queries"] = dict(kernels.LAUNCHES)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    qp = qenc.encode_documents(corpus_texts, batch_size=32, max_length=1024)
    qp_s = time.perf_counter() - t0
    path_counts["qwen3_passages"] = dict(kernels.LAUNCHES)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    qpk = qenc.encode_documents(corpus_texts, batch_size=32, max_length=1024, pack=True)
    qpk_s = time.perf_counter() - t0
    path_counts["qwen3_packed"] = dict(kernels.LAUNCHES)
    for label in ("qwen3_queries", "qwen3_passages", "qwen3_packed"):
        check(path_counts[label]["flash_attention_causal"] > 0, f"{label} did not launch kernel B causal")
    for name, x, rows in (("queries", qq, N_QWEN_QUERIES), ("passages", qp, N_CORPUS),
                          ("packed", qpk, N_CORPUS)):
        check(x.shape == (rows, DIM) and bool(np.isfinite(x).all()), f"Qwen3 {name} shape/finite")
        check(bool(np.allclose(np.linalg.norm(x, axis=1), 1.0, atol=2e-2)), f"Qwen3 {name} not unit norm")
    q_cos = float((qp * qpk).sum(axis=1).min())
    q_abs = float(np.abs(qp - qpk).max())
    check(q_cos >= 0.999 and q_abs <= TOL_PACKED_ABS,
          f"Qwen3 packed vs unpacked: min cos {q_cos}, max abs {q_abs}")
    # the same weights with plain attention (use_flash=False: the KV heads
    # repeated, a torch.matmul softmax) on the same queries, at their buckets
    qplain = load_encoder(qwen, str(qdir), use_flash=False)
    qplain.length_buckets = buckets
    check(not qplain.cfg.use_flash, "Qwen3 plain-attention load")
    kernels.reset_launch_counts()
    qq_plain = qplain.encode_queries(texts_a[:N_QWEN_QUERIES], batch_size=128)
    check(kernels.LAUNCHES["flash_attention_causal"] == 0, "the plain-attention Qwen3 launched kernel B")
    del qplain
    torch.cuda.empty_cache()
    qk_cos = float((qq * qq_plain).sum(axis=1).min())
    qk_abs = float(np.abs(qq - qq_plain).max())
    check(qk_cos >= 0.999 and qk_abs <= TOL_PACKED_ABS,
          f"Qwen3 queries, kernel B vs plain attention: min cos {qk_cos}, max abs {qk_abs}")
    # short texts packed: the 512 query texts (as passages, no query prompt)
    # share rows of 256, up to 16 segments a row, positions restarting at 0
    # in each (PACKED_POS = "zero") under the causal-within-segment mask;
    # against the same texts unpacked
    qtexts = texts_a[:N_QWEN_QUERIES]
    kernels.reset_launch_counts()
    qs_pk = qenc.encode_documents(qtexts, batch_size=128, pack=True)
    path_counts["qwen3_packed_short"] = dict(kernels.LAUNCHES)
    check(path_counts["qwen3_packed_short"]["flash_attention_causal"] > 0,
          "the packed short-text encode did not launch kernel B causal")
    qs_up = qenc.encode_documents(qtexts, batch_size=128)
    seq_s, rpb_s, pad_s = qenc._packed_setup(128, None)
    segs_per_row, row_lens = [], set()
    for _, _, pk, _ in qenc._packed_chunks([qtexts[i] for i in qenc._length_order(qtexts)],
                                           dialects.doc_prefix(qenc.name), seq_s, rpb_s, 16, pad_s, None):
        segs_per_row += [int(r.max()) for r in pk.segment_ids if r.max() > 0]
        row_lens.add(int(pk.ids.shape[1]))
    check(sum(segs_per_row) == N_QWEN_QUERIES and np.mean(segs_per_row) >= 4,
          f"packed short texts: {np.mean(segs_per_row)} segments a row")
    ps_cos = float((qs_pk * qs_up).sum(axis=1).min())
    ps_abs = float(np.abs(qs_pk - qs_up).max())
    check(qs_pk.shape == (N_QWEN_QUERIES, DIM) and bool(np.isfinite(qs_pk).all()), "Qwen3 packed short shape")
    check(ps_cos >= 0.999 and ps_abs <= TOL_PACKED_ABS,
          f"Qwen3 packed short texts vs unpacked: min cos {ps_cos}, max abs {ps_abs}")
    # kernel B's Qwen3 instance (causal, 16 query heads over 8 KV heads, dh =
    # 128) against its plain version at the query buckets (S = 16 and 64 sit
    # below one 128-row tile): ragged lengths, and rows packed as the packer
    # lays them out (contiguous segments, a pad tail) whose pad rows are 0
    rng10 = np.random.default_rng(SEED + 14)
    err_bq_s = {}
    for sb in (16, 64, 128, 256, 512):
        bb = 8
        qkv = [torch.randn(bb, sb, nh, 128, device=dev, generator=g10k).to(torch.bfloat16).transpose(1, 2)
               for nh in (16, 8, 8)]
        lens_r = rng10.integers(1, sb + 1, bb).astype(np.int32)
        lens_r[0] = sb
        seg = np.zeros((bb, sb), np.int32)
        for r in range(bb):
            pos, sid, fill = 0, 1, sb if r == 0 else int(rng10.integers(1, sb + 1))
            while pos < fill:
                n_ = min(int(rng10.integers(1, max(2, sb // 4) + 1)), fill - pos)
                seg[r, pos : pos + n_] = sid
                pos, sid = pos + n_, sid + 1
        seg_t = torch.from_numpy(seg).to(dev)
        for tag, lens_, seg_ in (("ragged", torch.from_numpy(lens_r).to(dev), None),
                                 ("packed", (seg_t > 0).sum(dim=1, dtype=torch.int32), seg_t)):
            o_ = fa.attention_flash(*qkv, lens_, causal=True, segment_ids=seg_)
            op_ = fa.attention_flash_plain(*(t.float() for t in qkv), lens_, causal=True, segment_ids=seg_)
            torch.cuda.synchronize()
            err_bq_s[f"S{sb}_{tag}"] = (o_.float() - op_).abs().max().item()
            check(err_bq_s[f"S{sb}_{tag}"] <= 2e-2, f"B causal GQA err {err_bq_s[f'S{sb}_{tag}']} S={sb} {tag}")
            if seg_ is not None:
                check(bool((o_[(seg_ == 0)[:, None, :, None].expand_as(o_)] == 0).all()),
                      f"B causal pad-segment rows not 0 at S={sb}")
    del qkv, o_, op_, seg_t
    # and at the 1024 bucket with full lengths, timed beside SDPA with the KV
    # heads repeated
    bq, hq, kvq, sq, dq = 32, 16, 8, 1024, 128
    qb_ = torch.randn(bq, sq, hq, dq, device=dev, generator=g10k).to(torch.bfloat16).transpose(1, 2)
    kb_ = torch.randn(bq, sq, kvq, dq, device=dev, generator=g10k).to(torch.bfloat16).transpose(1, 2)
    vb_ = torch.randn(bq, sq, kvq, dq, device=dev, generator=g10k).to(torch.bfloat16).transpose(1, 2)
    lens_q = torch.full((bq,), sq, dtype=torch.int32, device=dev)
    err_bq = (fa.attention_flash(qb_, kb_, vb_, lens_q, causal=True).float()
              - fa.attention_flash_plain(qb_.float(), kb_.float(), vb_.float(), lens_q, causal=True)
              ).abs().max().item()
    check(err_bq <= 2e-2, f"B causal GQA err {err_bq}")
    k_rep, v_rep = kb_.repeat_interleave(hq // kvq, dim=1), vb_.repeat_interleave(hq // kvq, dim=1)
    b_ms, b_by = bound(2 * bq * sq * hq * dq * 2 + 2 * bq * sq * kvq * dq * 2, 4 * bq * hq * sq * sq * dq / 2)
    late_entries.append(dict(
        name="flash_attention[causal]", route="cuda",
        source="codemix_dense_retrieval_torch/csrc/flash_attention.cu",
        replaces="codemix_dense_retrieval_tpu/ops/flash_attention.py:249", launches=None,
        max_abs_err=max(err_bq, *err_bq_s.values()),
        **kernel_ms(lambda: fa.attention_flash(qb_, kb_, vb_, lens_q, causal=True), 20),
        plain_ms=cuda_ms(lambda: fa.attention_flash_plain(qb_, kb_, vb_, lens_q, causal=True), 3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qb_, k_rep, v_rep, is_causal=True), 20),
        shape=f"B={bq} H={hq} KVH={kvq} S={sq} dh={dq} bf16 causal (Qwen3-Embedding-0.6B)",
    ))
    del qb_, kb_, vb_, k_rep, v_rep
    # every bucket the Qwen3 encoder runs kernel B at (B = 128 queries to S =
    # 256, B = 32 passages at 512 and 1024), full and ragged lengths, each
    # beside SDPA (is_causal, KV heads repeated: no lengths, so its work is
    # the full causal square) and the bound of the keys these lengths need
    qwen_buckets = {}
    for sb in (16, 64, 128, 256, 512, 1024):
        bb = 128 if sb <= 256 else 32
        q_, k_, v_ = (torch.randn(bb, sb, nh, dq, device=dev, generator=g10k).to(torch.bfloat16).transpose(1, 2)
                      for nh in (hq, kvq, kvq))
        k_rep, v_rep = k_.repeat_interleave(hq // kvq, dim=1), v_.repeat_interleave(hq // kvq, dim=1)
        reps = max(20, min(400, 20 * 32 * 1024 * 1024 // (bb * sb * sb)))
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q_, k_rep, v_rep, is_causal=True), reps)
        lens_r = rng10.integers(1, sb + 1, bb).astype(np.int32)
        for tag, lens_np in (("full", np.full(bb, sb, np.int32)), ("ragged", lens_r)):
            lens_ = torch.from_numpy(lens_np).to(dev)
            err_ = (fa.attention_flash(q_, k_, v_, lens_, causal=True).float()
                    - fa.attention_flash_plain(q_.float(), k_.float(), v_.float(), lens_, causal=True)
                    ).abs().max().item()
            check(err_ <= 2e-2, f"B causal GQA err {err_} at S={sb} {tag}")
            keys = float(np.minimum(np.arange(sb)[None, :] + 1, lens_np[:, None].astype(np.int64)).sum())
            b_ms_, b_by_ = bound(2 * bb * sb * (hq + kvq) * dq * 2, 4 * hq * dq * keys)
            _, tiles_ = fa.tile_schedule(bb, hq, kvq, sb, True)
            qwen_buckets[f"S{sb}_{tag}"] = dict(
                B=bb, max_abs_err=err_, **kernel_ms(lambda: fa.attention_flash(q_, k_, v_, lens_, causal=True), reps),
                sdpa_ms=lib_ms, bound_ms=b_ms_, bound_by=b_by_,
                schedule_balance=fa.schedule_balance(tiles_, lens_np, True))
        del q_, k_, v_, k_rep, v_rep
    say("qwen3_kernel_b_buckets", smi=smi, shape="H=16 KVH=8 dh=128 bf16 causal", buckets=qwen_buckets)
    del qenc
    torch.cuda.empty_cache()
    say("qwen3", config="Qwen3-Embedding-0.6B (28L, d=1024, 16/8 heads of 128, FFN 3072, vocab 151669) "
        "random init bf16, HF-format dir", load_s=round(qload_s, 2),
        queries=N_QWEN_QUERIES, queries_per_s=round(N_QWEN_QUERIES / qq_s, 1), passages=N_CORPUS,
        passages_per_s=round(N_CORPUS / qp_s, 1), packed_passages_per_s=round(N_CORPUS / qpk_s, 1),
        packed_vs_unpacked={"min_cos": q_cos, "max_abs": q_abs},
        queries_kernel_vs_plain_attention={"min_cos": qk_cos, "max_abs": qk_abs},
        packed_short_texts={"texts": N_QWEN_QUERIES, "row_lengths": sorted(row_lens), "rows": len(segs_per_row),
                            "mean_segments_per_row": float(np.mean(segs_per_row)),
                            "max_segments_per_row": max(segs_per_row), "min_cos": ps_cos, "max_abs": ps_abs},
        tolerance={"min_cos": 0.999, "max_abs": TOL_PACKED_ABS},
        kernel_b_causal_max_abs_err={**err_bq_s, "S1024": err_bq}, kernel_b_tolerance=2e-2,
        launches={k: path_counts[k] for k in ("qwen3_queries", "qwen3_passages", "qwen3_packed",
                                              "qwen3_packed_short")})

    # 10b. the CLI over f32 and f16 stores: encode-corpus with the Qwen3
    # checkpoint (rows and a 32-token store of the dtype), run-mix exact and
    # guaranteed (kernel 2; kernel 7 over the bf16 sketch), run-rerank
    # (kernel 6 over the f32 / f16 token store)
    def trec_ids(path, k=100):
        got = {}
        with open(path) as fh:
            for line in fh:
                qid, _, doc, _, score, _ = line.split()
                got.setdefault(qid, []).append((int(doc.split("#")[0][1:]), float(score)))
        check(len(got) == N_QUERIES and all(len(v) == k for v in got.values()), f"{path} shape")
        return (np.array([[d for d, _ in got[q]] for q in qids]),
                np.array([[v for _, v in got[q]] for q in qids]))

    cli10 = {}
    for sdt in ("float32", "float16"):
        sfx = kernels.dtype_suffix(getattr(torch, sdt))
        root = work / f"corpus_{sdt}"
        common = ["--encoder", qwen, "--checkpoint", str(qdir), "--seed", str(SEED)]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        run_cli(["codemix_dense_retrieval_torch", "encode-corpus", *common, "--corpus_tsv", f"xx={corpus_tsv}",
                 "--storage_dtype", sdt, "--token_dtype", sdt, "--tokens_per_doc", str(TD),
                 "--out", str(root), "--batch", "512", "--enc_batch", "32"])
        enc_s = time.perf_counter() - t0
        path_counts[f"qwen3_corpus_{sdt}"] = dict(kernels.LAUNCHES)
        check(path_counts[f"qwen3_corpus_{sdt}"]["flash_attention_causal"] > 0,
              f"encode-corpus ({sdt}) did not launch kernel B causal")
        store10 = ShardStore.open(root / "xx")
        tok10 = TokenShardStore.open(root / "xx" / "tokens")
        check(store10.count == N_CORPUS and store10.manifest.dtype == sdt and tok10.dtype == sdt
              and tok10.count == N_CORPUS, f"encode-corpus {sdt} store / token store")
        runs10 = {}
        for mode in ("off", "guaranteed"):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            run_cli(["codemix_dense_retrieval_torch", "run-mix", *common, "--index", str(root / "xx"),
                     "--query_tsv", f"en={work / 'en.tsv'}", f"zh={work / 'zh.tsv'}",
                     "--outdir", str(root / f"runs_{mode}"), "--k", "100", "--qblock", "256",
                     "--cm_alphas", "0.5", "--query_cache", str(root / "qcache"), "--approx", mode])
            runs10[mode] = (time.perf_counter() - t0, trec_ids(root / f"runs_{mode}" / "cm-alpha-0.5.trec"))
            path_counts[f"qwen3_run_mix_{sdt}_{mode}"] = dict(kernels.LAUNCHES)
            check(path_counts[f"qwen3_run_mix_{sdt}_{mode}"][f"bin_scores_transposed{sfx}"] > 0,
                  f"run-mix {mode} over the {sdt} store did not launch kernel 2 ({sdt})")
        check(path_counts[f"qwen3_run_mix_{sdt}_guaranteed"]["binub"] > 0
              and path_counts[f"qwen3_run_mix_{sdt}_guaranteed"]["super_select"] > 0,
              f"run-mix guaranteed over the {sdt} store did not launch kernel 7 and super_select")
        check(np.array_equal(runs10["guaranteed"][1][0], runs10["off"][1][0]),
              f"run-mix --approx guaranteed over the {sdt} store differs from the exact run")
        # the exact run against a plain top-k of the store's rows (f32 products
        # of the dtype's values): rank by rank the same score, within the TREC
        # file's 4 decimals and TIE_TOL (so ids differ only among ties)
        _, va10 = load_query_cache(root / "qcache" / "en" / "queries.npz", expected_qids=qids)
        _, vb10 = load_query_cache(root / "qcache" / "zh" / "queries.npz", expected_qids=qids)
        mq10 = mix_and_renorm(torch.from_numpy(va10).to(dev), torch.from_numpy(vb10).to(dev), 0.5)
        rows10 = store10.rows().to(dev)
        wv10, wi10 = topk._stable_topk(mq10.to(rows10.dtype).float() @ rows10.float().T, 100)
        gi10, gv10 = runs10["off"][1]
        gap10 = float(np.abs(gv10 - wv10.cpu().numpy()).max())
        check(gap10 <= 5e-5 + TIE_TOL, f"run-mix over the {sdt} store: rank-wise score gap {gap10} to the plain top-k")
        # run-mix --fused --qrels (the sweep on the card, qrels: the exact
        # run's top-1): the exact run's ids, RR@10 = 100
        top1 = {}
        with open(root / "runs_off" / "cm-alpha-0.5.trec") as fh:
            for line in fh:
                top1.setdefault(line.split()[0], line.split()[2])
        (root / "qrels.tsv").write_text("".join(f"{q}\t{top1[q]}\t1\n" for q in qids))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        fused10 = run_cli_json(["codemix_dense_retrieval_torch", "run-mix", *common, "--index", str(root / "xx"),
                                "--query_tsv", f"en={work / 'en.tsv'}", f"zh={work / 'zh.tsv'}",
                                "--outdir", str(root / "runs_fused"), "--k", "100", "--qblock", "256",
                                "--cm_alphas", "0.5", "--query_cache", str(root / "qcache"), "--fused",
                                "--qrels", str(root / "qrels.tsv")])
        fused10_s = time.perf_counter() - t0
        path_counts[f"qwen3_run_mix_{sdt}_fused"] = dict(kernels.LAUNCHES)
        check(path_counts[f"qwen3_run_mix_{sdt}_fused"][f"bin_scores_transposed{sfx}"] > 0,
              f"run-mix --fused over the {sdt} store did not launch kernel 2 ({sdt})")
        check(np.array_equal(trec_ids(root / "runs_fused" / "cm-alpha-0.5.trec")[0], gi10)
              and fused10["0.5"]["RR@10"] == 100.0,
              f"run-mix --fused over the {sdt} store differs from the exact run")
        # the fused bilingual hub: the store and a parallel second language
        # of its dtype (row i = normalize(row_i + 0.3 u_i), the same docids),
        # k = 100 over a 200-deep raw search collapsed on the card; rank-wise
        # the plain top-k of each document's larger score of the two
        u = torch.randn(rows10.shape, device=dev, generator=g10k)
        y = rows10.float() + 0.3 * u / u.norm(dim=1, keepdim=True)
        rows_yy = (y / y.norm(dim=1, keepdim=True)).to(rows10.dtype)
        del u, y
        hub10 = DenseFlatIndex.merged([
            DenseFlatIndex.build(rows10.cpu(), store10.docids, dtype=sdt, lang="xx"),
            DenseFlatIndex.build(rows_yy.cpu(), store10.docids, dtype=sdt, lang="yy")]).to_device()
        check(hub10._docs_dev[0].dtype == rows10.dtype, f"the {sdt} hub's rows")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        hub_runs, hub_m = run_bilingual_vector_mix_fused(hub10, qids, va10, vb10, [0.5], root / "hub", k=100,
                                                         qrels={q: {top1[q].split("#")[0]: 1} for q in qids},
                                                         query_block=256)
        hub10_s = time.perf_counter() - t0
        path_counts[f"qwen3_hub_fused_{sdt}"] = dict(kernels.LAUNCHES)
        check(path_counts[f"qwen3_hub_fused_{sdt}"][f"bin_scores_transposed{sfx}"] > 0,
              f"the fused hub over {sdt} stores did not launch kernel 2 ({sdt})")
        qh = mq10.to(rows10.dtype).float()
        hv10, hi10 = topk._stable_topk(torch.maximum(qh @ rows10.float().T, qh @ rows_yy.float().T), 100)
        hgi, hgv = trec_ids(hub_runs[0.5])
        hub_gap = float(np.abs(hgv - hv10.cpu().numpy()).max())
        check(hub_gap <= 5e-5 + TIE_TOL, f"the fused hub over {sdt} stores: rank-wise score gap {hub_gap}")
        hi10_np = hi10.cpu().numpy()
        del hub10, rows_yy, qh, hv10, hi10
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        run_cli(["codemix_dense_retrieval_torch", "run-rerank", *common, "--index", str(root / "xx"),
                 "--queries", str(work / "en.tsv"), "--outdir", str(root / "rerank"), "--k", "100",
                 "--k_dense", str(K_DENSE), "--qblock", "256"])
        rr_s = time.perf_counter() - t0
        path_counts[f"qwen3_rerank_{sdt}"] = dict(kernels.LAUNCHES)
        check(path_counts[f"qwen3_rerank_{sdt}"][f"maxsim{sfx}"] > 0,
              f"run-rerank over the {sdt} token store did not launch kernel 6 ({sdt})")
        trec_ids(root / "rerank" / "en.trec")
        cli10[sdt] = dict(encode_corpus_s=round(enc_s, 2), run_mix_s=round(runs10["off"][0], 2),
                          run_mix_guaranteed_s=round(runs10["guaranteed"][0], 2), run_rerank_s=round(rr_s, 2),
                          exact_overlap_plain=overlap(gi10, wi10.cpu().numpy()), max_rank_score_gap=gap10,
                          guaranteed_ids_equal_exact=True, run_mix_fused_s=round(fused10_s, 2),
                          fused_ids_equal_exact=True, fused_rr10=fused10["0.5"]["RR@10"],
                          hub_fused_s=round(hub10_s, 2), hub_rows=2 * N_CORPUS, hub_max_rank_score_gap=hub_gap,
                          hub_overlap_plain=overlap(hgi, hi10_np), hub_rr10=hub_m["0.5"]["RR@10"])
        del rows10, mq10, wv10, wi10
    say("store_dtypes_cli", encoder=qwen, docs=N_CORPUS, tokens_per_doc=TD, queries=N_QUERIES, **cli10)

    # 10c. f32 and f16 stores at full size: 8,841,823 x 1024 unit Gaussian
    # rows made on the card in f32 (full mantissas; each query's planted row
    # near its alpha = .5 mix, made as in phase 5), one host copy (36.2 GB), the
    # f32 index (36.2 GB on the card) beside nothing else: fit_query_block
    # keeps the 256-query block (10.2 GB of scores and bin maxima)
    gc.collect()
    torch.cuda.empty_cache()
    card_gb_10c = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    # first the new instances at phase 3's tile edges: 1, 7, 64, 100, 130
    # and 257 queries, ragged n_valid (a device int for 7 and 130) and
    # n_valid = 1000, G = 8 and 16, d = 1024 and 96 (half a chunk), f32 and
    # bf16 scores, kernel 7 at ds = 96, 128 and 512; f32 operands with full
    # mantissas, held to TOL_F32 (f16 to 1e-4, bf16 scores to one ulp)
    edge10 = {}

    def edge(name, err):
        edge10[name] = max(edge10.get(name, 0.0), err)

    def check_new(q, docs, nv, n_valid, g_, layout, sdt, tol, label):
        s_, bm_ = topk.bin_scores(q, docs, nv, g_, layout=layout, score_dtype=sdt)
        s2_, bm2_ = topk.bin_scores_plain(q, docs, nv, g_, layout=layout, score_dtype=sdt)
        torch.cuda.synchronize()
        if layout == "transposed":
            s_, s2_, bm_, bm2_ = s_.T, s2_.T, bm_.T, bm2_.T
        a_, r_ = s_[:, :n_valid].float(), s2_[:, :n_valid].float()
        diff = (a_ - r_).abs()
        lim = tol if sdt == torch.float32 else torch.maximum(a_.abs(), r_.abs()) * 2.0 ** -7 + tol
        check(bool((diff <= lim).all()), f"{label} scores: max diff {diff.max().item()}")
        check(bool((s_[:, n_valid:].float() == torch.tensor(topk.NEG_INF).to(sdt).float()).all()),
              f"{label} pad scores")
        bdiff = (bm_ - bm2_).abs().max().item()
        check(bdiff <= tol and bool((bm_[:, -(-n_valid // g_):] == topk.NEG_INF).all()),
              f"{label} bin maxima: max diff {bdiff}")
        return max(bdiff, diff.max().item() if sdt == torch.float32 else 0.0)

    for dt, tol, label in ((torch.float16, 1e-4, "f16"), (torch.float32, TOL_F32, "f32")):
        n_e = 16_384 + 16 * 7
        docs_e, docs_96 = unit(n_e).to(dt), unit(4096, 96).to(dt)
        for b in (1, 7, 64, 100, 130, 257):
            q_e, q_96 = unit(b).to(dt), unit(b, 96).to(dt)
            nv_e = n_e - 77
            nv_arg = torch.tensor([nv_e], dtype=torch.int32, device=dev) if b in (7, 130) else nv_e
            for g_ in (8, 16):
                for layout in topk.LAYOUTS:
                    for sdt in (torch.float32, torch.bfloat16):
                        edge(f"bin_scores[{layout}_{label}]", check_new(
                            q_e, docs_e, nv_arg, nv_e, g_, layout, sdt, tol,
                            f"{layout} {label} b={b} G={g_} {sdt}"))
                edge(f"bin_scores[bin_major_{label}]", check_new(
                    q_e, docs_e, 1000, 1000, g_, "bin_major", torch.float32, tol, f"nv=1000 {label} b={b}"))
                edge(f"bin_scores[bin_major_{label}]", check_new(
                    q_96, docs_96, 4096 - 40, 4096 - 40, g_, "bin_major", torch.float32, tol,
                    f"d=96 {label} b={b}"))
                bmo, bmo2 = topk.binmax_only(q_e, docs_e, nv_arg, g_), topk.binmax_only_plain(q_e, docs_e, nv_e, g_)
                torch.cuda.synchronize()
                err_o = (bmo - bmo2).abs().max().item()
                check(err_o <= tol, f"binmax_only {label} b={b} G={g_}: {err_o}")
                edge(f"binmax_only[{label}]", err_o)
    for ds_ in (96, 128, 512):
        d_sk = torch.randn(8192, ds_, device=dev, generator=g10k) * 0.1
        d_tl = torch.rand(8192, device=dev, generator=g10k)
        for b in (1, 7, 257):
            q_sk_ = torch.randn(b, ds_, device=dev, generator=g10k) * 0.1
            q_tl_ = torch.rand(b, device=dev, generator=g10k)
            for nv7 in (8192 - 13, 1000):
                u7 = sk.binub(q_sk_, q_tl_, d_sk, d_tl, 8, nv7)
                u72 = sk.binub_plain(q_sk_, q_tl_, d_sk, d_tl, 8, nv7)
                torch.cuda.synchronize()
                err7e = (u7 - u72).abs().max().item()
                check(err7e <= TOL_F32, f"7 (f32) ds={ds_} b={b} nv={nv7}: {err7e}")
                edge("binub[f32]", err7e)
    del docs_e, docs_96, d_sk, d_tl
    # kernel 2 f32 (bin_scores_f32_kernel's transposed epilogue) at its edges:
    # B on both sides of the n64 / n128 tiles and of a second query tile, N =
    # 128 k + 16 (a ragged last row tile), hubness_stats' 20,000 rows and the
    # CLI store's 131,072, n_valid = N - 77 (a device int for odd B), d = 32,
    # 96 and 1024, G = 8 and 16, f32 and bf16 scores, held to TOL_F32 (bf16
    # scores to one ulp); its own generator, so later draws stay as they were
    t0 = time.perf_counter()
    g2e = torch.Generator(device=dev).manual_seed(SEED + 15)

    def unit2(n, d):
        x = torch.randn(n, d, device=dev, generator=g2e)
        return x / x.norm(dim=1, keepdim=True)

    for n_e2 in (128 * 100 + 16, 20_000, SMALL_ROWS):
        nv_e2 = n_e2 - 77
        nv_dev = torch.tensor([nv_e2], dtype=torch.int32, device=dev)
        for d_e2 in (32, 96, DIM):
            docs_e2 = unit2(n_e2, d_e2)
            for b in (1, 63, 64, 65, 128, 129, 255, 256):
                q_e2 = unit2(b, d_e2)
                for g_ in (8, 16):
                    for sdt in (torch.float32, torch.bfloat16):
                        edge("bin_scores[transposed_f32]", check_new(
                            q_e2, docs_e2, nv_dev if b % 2 else nv_e2, nv_e2, g_, "transposed", sdt,
                            TOL_F32, f"2 f32 b={b} N={n_e2} d={d_e2} G={g_} {sdt}"))
    del docs_e2, q_e2, nv_dev
    edges2_f32_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host32 = torch.empty((N_ROWS, DIM), dtype=torch.float32)
    g10 = torch.Generator(device=dev).manual_seed(SEED + 11)
    for c0 in range(0, N_ROWS, 1 << 20):
        c1 = min(c0 + (1 << 20), N_ROWS)
        x = torch.randn(c1 - c0, DIM, device=dev, generator=g10)
        host32[c0:c1].copy_(x / x.norm(dim=1, keepdim=True))
    noise = torch.randn(N_QUERIES, DIM, device=dev, generator=g10)
    near10 = mix05 + 0.5 * noise / noise.norm(dim=1, keepdim=True)
    host32[planted] = (near10 / near10.norm(dim=1, keepdim=True)).cpu()
    del x, noise, near10
    gen32_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx32 = DenseFlatIndex.build(host32, docids, dtype="float32").to_device()
    torch.cuda.synchronize()
    up32_s = time.perf_counter() - t0
    del host32
    d32, nv32 = idx32._docs_dev[0], idx32._counts_dev[0]
    nb32 = d32.shape[0]
    check(d32.dtype == torch.float32 and idx32._rows_per_shard >= topk.TWO_LEVEL_MIN_ROWS, "f32 index")
    q32 = mix05.float().contiguous()

    def full_size_search(idx, q, label):
        """Exact search at k = 100 and 1000 (512 queries, 256-query blocks)
        against the plain f32 top-k of the index dtype's values: (overlap at
        k = 1000, largest rank-wise score gap, seconds)."""
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        v100, i100 = idx.search(q, 100, query_block=256, return_docids=False)
        v1000, i1000 = idx.search(q, 1000, query_block=256, return_docids=False)
        sec = time.perf_counter() - t0
        path_counts[label] = dict(kernels.LAUNCHES)
        qd = q.to(idx._docs_dev[0].dtype).float()
        wv, wi = oracle_topk(qd, idx._docs_dev[0], N_ROWS, 1000)
        wv, wi = wv.cpu().numpy(), wi.cpu().numpy()
        gap = max(float(np.abs(v100 - wv[:, :100]).max()), float(np.abs(v1000 - wv).max()))
        check(gap <= TIE_TOL, f"{label}: rank-wise score gap {gap} to the plain top-k")
        return overlap(i1000, wi), overlap(i100, wi[:, :100]), gap, sec

    def tiers(idx, label):
        """The fused alpha sweep (the phase-5 query pairs, k = 100) and the
        adaptive tier (k = 1, where the planted rows certify, and k = 100)
        over the index: the fused ids at alpha = .5 and the adaptive values
        and ids equal exact search's on q32."""
        sfx = kernels.dtype_suffix(idx._docs_dev[0].dtype)
        exact = {k_: idx.search(q32, k_, query_block=256, return_docids=False) for k_ in (1, 100)}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        _, f_ids, _, _ = fused_alpha_sweep(qa, qb, ALPHAS, idx._docs_dev[0], idx._counts_dev, 100,
                                           search_kwargs=idx.search_kwargs, query_block=256)
        f_ids = f_ids.cpu().numpy()
        out = {"fused_s": round(time.perf_counter() - t0, 2)}
        path_counts[f"fused_{label}"] = dict(kernels.LAUNCHES)
        # f16 takes kernel 5 and cover_rescore, f32 kernel A's store (topk.rescores_cover)
        route = ((f"binmax_only{sfx}", f"cover_rescore{sfx}") if label == "f16"
                 else (f"bin_scores_bin_major{sfx}",))
        check(all(path_counts[f"fused_{label}"][name] > 0 for name in route),
              f"the fused sweep over the {label} index did not launch {route}")
        check(np.array_equal(f_ids[ALPHAS.index(0.5)], exact[100][1]),
              f"the fused sweep over the {label} index differs from exact search at alpha = .5")
        out["fused_ids_equal_exact"] = True
        for k_ in (1, 100):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            av, ai = idx.search(q32, k_, query_block=256, approx="adaptive", return_docids=False)
            out[f"adaptive_k{k_}_s"] = round(time.perf_counter() - t0, 2)
            path_counts[f"adaptive_{label}_k{k_}"] = dict(kernels.LAUNCHES)
            check(path_counts[f"adaptive_{label}_k{k_}"][f"bin_scores_bin_major{sfx}"] > 0
                  and path_counts[f"adaptive_{label}_k{k_}"]["super_select"] > 0,
                  f"the adaptive tier over the {label} index did not launch kernel A ({label}) and super_select")
            check(np.array_equal(ai, exact[k_][1]) and np.array_equal(av, exact[k_][0]),
                  f"the adaptive tier over the {label} index differs from exact search at k = {k_}")
            out[f"adaptive_k{k_}"] = dict(idx.last_adaptive_stats)
        out["adaptive_equal_exact"] = True
        return out

    ov32 = full_size_search(idx32, q32, "search_f32")
    check(path_counts["search_f32"]["bin_scores_bin_major_f32"] > 0 and path_counts["search_f32"]["super_select"] > 0,
          "f32 search did not launch kernel A (f32) and super_select")
    tiers32 = tiers(idx32, "f32")
    # the rescore search (kernel 5) at k = 100 and 1000
    kernels.reset_launch_counts()
    qd32 = q32[:256].contiguous()
    rv5, ri5 = topk.topk_ip(qd32, d32, 100, method="bins_rescore", n_valid=nv32)
    rv5k, ri5k = topk.topk_ip_rescore_two_level(qd32, d32, 1000, n_valid=nv32)
    path_counts["rescore_f32"] = dict(kernels.LAUNCHES)
    check(path_counts["rescore_f32"]["binmax_only_f32"] > 0 and path_counts["rescore_f32"]["super_select"] > 0,
          "f32 rescore did not launch kernel 5 (f32) and super_select")
    wv5, wi5 = oracle_topk(qd32, d32, N_ROWS, 1000)
    gap5 = max(float((rv5 - wv5[:, :100]).abs().max()), float((rv5k - wv5).abs().max()))
    check(gap5 <= TIE_TOL, f"f32 rescore: rank-wise score gap {gap5} to the plain top-k")
    ov5 = overlap(ri5k.cpu().numpy(), wi5.cpu().numpy())
    del rv5, ri5, rv5k, ri5k, wv5, wi5
    # the sketch tier over the f32 index (its sketch stays bf16), guaranteed:
    # the exact ids
    t0 = time.perf_counter()
    idx32.enable_sketch(sketch_dim=128, cache=False)
    sk_build_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    ev32, ei32 = idx32.search(q32, 100, query_block=256, return_docids=False)
    path_counts["sketch_f32_exact"] = dict(kernels.LAUNCHES)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    gv32, gi32 = idx32.search(q32, 100, query_block=256, approx="guaranteed", return_docids=False)
    grt32_s = time.perf_counter() - t0
    path_counts["sketch_f32_guaranteed"] = dict(kernels.LAUNCHES)
    check(path_counts["sketch_f32_guaranteed"]["binub"] > 0
          and path_counts["sketch_f32_guaranteed"]["super_select"] > 0,
          "the f32 index's sketch tier did not launch kernel 7 and super_select")
    check(np.array_equal(gi32, ei32), "guaranteed search over the f32 index differs from exact search")
    # the f32 sketch tier (ops.sketch with an f32 sidecar, the JAX package's
    # HIGHEST-precision tier): kernel 7 over f32 operands; certified queries
    # return the exact ids
    _, _, proj32, _ = idx32._sketch
    idx32._sketch = None
    torch.cuda.empty_cache()
    sk32, tl32 = sk.sketch_rows(d32, proj32, torch.float32)
    kernels.reset_launch_counts()
    fv32, fi32, fc32 = sk.topk_ip_sketch(q32, d32, sk32, tl32, proj32, 100, n_valid=nv32)
    path_counts["sketch_f32_sidecar"] = dict(kernels.LAUNCHES)
    check(path_counts["sketch_f32_sidecar"]["binub_f32"] > 0 and path_counts["sketch_f32_sidecar"]["super_select"] > 0,
          "the f32 sketch tier did not launch kernel 7 (f32) and super_select")
    fc32 = fc32.cpu().numpy()
    check(bool((fi32.cpu().numpy()[fc32] == ei32[fc32]).all()), "certified f32-sketch queries differ from exact")
    del fv32, fi32
    # kernel 7 (f32 sketch) against its plain version and timed
    q_sk32, q_tl32, _ = _sketch_with_err(q32[:256], proj32, torch.float32)
    ub = sk.binub(q_sk32, q_tl32, sk32, tl32, 8, nv32)
    ub2 = sk.binub_plain(q_sk32, q_tl32, sk32, tl32, 8, nv32)
    torch.cuda.synchronize()
    err7f = (ub - ub2).abs().max().item()
    check(err7f <= TOL_F32, f"7 (f32) err {err7f} at the main shape")
    del ub, ub2
    col32 = torch.arange(nb32, device=dev)

    def lib_binub32():
        s = torch.matmul(q_sk32, sk32.T)
        s.addr_(q_tl32, tl32)
        return s.masked_fill_(col32 >= nv32, -torch.inf).view(256, nb32 // 8, 8).amax(dim=2)

    b_ms, b_by = bound(256 * 128 * 4 + 256 * 4 + nb32 * 128 * 4 + nb32 * 4 + 256 * nb32 // 8 * 4,
                       3 * 2 * 256 * nb32 * 128, TF32_FLOPS)
    late_entries.append(dict(
        name="binub[f32]", route="cuda", source="codemix_dense_retrieval_torch/csrc/bin_scores_f32.cu",
        replaces="codemix_dense_retrieval_tpu/ops/sketch.py:310", launches=None,
        max_abs_err=max(err7f, edge10["binub[f32]"]),
        **kernel_ms(lambda: sk.binub(q_sk32, q_tl32, sk32, tl32, 8, nv32), 5),
        plain_ms=cuda_ms(lambda: sk.binub_plain(q_sk32, q_tl32, sk32, tl32, 8, nv32), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib_binub32, 3),
        shape=f"B=256 N={nb32} ds=128 G=8 f32 sketch (3xTF32), bin-major upper-bound maxima",
    ))
    del sk32, tl32, q_sk32, q_tl32
    torch.cuda.empty_cache()

    def float_entries(docs, nv, dt, label, source, tol, peak, passes):
        """Kernels A and 5 (at the full size) and 2 (on its first 131,072
        rows) over the index dtype ``dt``: each against its plain version at
        tolerance ``tol``, timed beside its plain version and one PyTorch
        call; ``passes`` tensor-core passes at ``peak`` bound the work."""
        esz = torch.finfo(dt).bits // 8
        nb = docs.shape[0]
        q = q32[:256].to(dt).contiguous()
        col = torch.arange(nb, device=dev)
        err_a = bin_kernel_err(lambda: topk.bin_scores(q, docs, nv, 8, layout="bin_major"),
                               lambda: topk.bin_scores_plain(q, docs, nv, 8, layout="bin_major"),
                               nv, "bin_major", tol, f"A ({label})")

        def lib_bm():
            s = torch.matmul(q, docs.T).float().masked_fill_(col >= nv, -torch.inf)
            return s.view(256, nb // 8, 8).amax(dim=2)

        lib_a = cuda_ms(lib_bm, 3)
        b_ms, b_by = bound(256 * DIM * esz + nb * DIM * esz + 256 * nb * 4 + 256 * nb // 8 * 4,
                           passes * 2 * 256 * nb * DIM, peak)
        out = [dict(
            name=f"bin_scores[bin_major_{label}]", route="cuda", source=source,
            replaces="codemix_dense_retrieval_tpu/ops/topk.py:492", launches=None, max_abs_err=err_a,
            **kernel_ms(lambda: topk.bin_scores(q, docs, nv, 8, layout="bin_major"), 5),
            plain_ms=cuda_ms(lambda: topk.bin_scores_plain(q, docs, nv, 8, layout="bin_major"), 2),
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_a,
            shape=f"B=256 N={nb} d={DIM} G=8 {label}, f32 scores",
        )]
        bm5_ = topk.binmax_only(q, docs, nv, 8)
        bm5p_ = topk.binmax_only_plain(q, docs, nv, 8)
        torch.cuda.synchronize()
        err_5 = (bm5_ - bm5p_).abs().max().item()
        check(err_5 <= tol, f"5 ({label}) err {err_5} at the main shape")
        del bm5_, bm5p_
        b_ms, b_by = bound(256 * DIM * esz + nb * DIM * esz + 256 * nb // 8 * 4,
                           passes * 2 * 256 * nb * DIM, peak)
        out.append(dict(
            name=f"binmax_only[{label}]", route="cuda", source=source,
            replaces="codemix_dense_retrieval_tpu/ops/topk.py:710", launches=None, max_abs_err=err_5,
            **kernel_ms(lambda: topk.binmax_only(q, docs, nv, 8), 5),
            plain_ms=cuda_ms(lambda: topk.binmax_only_plain(q, docs, nv, 8), 2),
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_a,
            shape=f"B=256 N={nb} d={DIM} G=8 {label}, bin-major maxima only",
        ))
        ds_ = docs[:SMALL_ROWS]
        ns = SMALL_ROWS
        col_t = torch.arange(ns, device=dev)[:, None]
        err_2 = bin_kernel_err(lambda: topk.bin_scores(q, ds_, ns, 16, layout="transposed"),
                               lambda: topk.bin_scores_plain(q, ds_, ns, 16, layout="transposed"),
                               torch.tensor(ns), "transposed", tol, f"2 ({label})")

        def lib_tr():
            s = torch.matmul(ds_, q.T).float().masked_fill_(col_t >= ns, -torch.inf)
            return s.view(ns // 16, 16, 256).amax(dim=1)

        b_ms, b_by = bound(256 * DIM * esz + ns * DIM * esz + 256 * ns * 4 + 256 * ns // 16 * 4,
                           passes * 2 * 256 * ns * DIM, peak)
        entry = dict(
            name=f"bin_scores[transposed_{label}]", route="cuda", source=source,
            replaces="codemix_dense_retrieval_tpu/ops/topk.py:389", launches=None, max_abs_err=err_2,
            **kernel_ms(lambda: topk.bin_scores(q, ds_, ns, 16, layout="transposed"), 20),
            plain_ms=cuda_ms(lambda: topk.bin_scores_plain(q, ds_, ns, 16, layout="transposed"), 5),
            bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib_tr, 20),
            shape=f"B=256 N={ns} d={DIM} G=16 {label}, f32 scores",
        )
        # the same kernel at hubness_stats' shape (a 20,000-row sample, 256-query
        # blocks): 157 row tiles x 2 query tiles on the card's SMs
        nh = 20_000
        dh = docs[:nh]
        col_h = col_t[:nh]

        def lib_hub():
            s = torch.matmul(dh, q.T).float().masked_fill_(col_h >= nh, -torch.inf)
            return s.view(nh // 16, 16, 256).amax(dim=1)

        hb_ms, hb_by = bound(256 * DIM * esz + nh * DIM * esz + 256 * nh * 4 + 256 * nh // 16 * 4,
                             passes * 2 * 256 * nh * DIM, peak)
        entry["hubness_shape"] = dict(
            shape=f"B=256 N={nh} d={DIM} G=16 {label}, f32 scores",
            **kernel_ms(lambda: topk.bin_scores(q, dh, nh, 16, layout="transposed"), 40),
            plain_ms=cuda_ms(lambda: topk.bin_scores_plain(q, dh, nh, 16, layout="transposed"), 10),
            bound_ms=hb_ms, bound_by=hb_by, library_ms=cuda_ms(lib_hub, 40))
        out.append(entry)
        return out

    f32_entries = float_entries(d32, nv32, torch.float32, "f32",
                                "codemix_dense_retrieval_torch/csrc/bin_scores_f32.cu", TOL_F32, TF32_FLOPS, 3)
    # the f16 store: the same rows rounded to f16 (one 18.1 GB host copy)
    t0 = time.perf_counter()
    host16 = torch.empty((N_ROWS, DIM), dtype=torch.float16)
    for c0 in range(0, N_ROWS, 1 << 20):
        host16[c0 : c0 + (1 << 20)].copy_(d32[c0 : min(c0 + (1 << 20), N_ROWS)].half())
    del d32, nv32, idx32, col32
    torch.cuda.empty_cache()
    idx16 = DenseFlatIndex.build(host16, docids, dtype="float16").to_device()
    torch.cuda.synchronize()
    up16_s = time.perf_counter() - t0
    del host16
    d16, nv16 = idx16._docs_dev[0], idx16._counts_dev[0]
    ov16 = full_size_search(idx16, q32, "search_f16")
    check(path_counts["search_f16"]["binmax_only_f16"] > 0 and path_counts["search_f16"]["cover_rescore_f16"] > 0
          and path_counts["search_f16"]["super_select"] > 0,
          "f16 search did not launch kernel 5 and cover_rescore (f16) and super_select")
    tiers16 = tiers(idx16, "f16")
    kernels.reset_launch_counts()
    rv5h, _ = topk.topk_ip(q32[:256].half(), d16, 100, method="bins_rescore", n_valid=nv16)
    path_counts["rescore_f16"] = dict(kernels.LAUNCHES)
    check(path_counts["rescore_f16"]["binmax_only_f16"] > 0, "f16 rescore did not launch kernel 5 (f16)")
    del rv5h
    f16_entries = float_entries(d16, nv16, torch.float16, "f16",
                                "codemix_dense_retrieval_torch/csrc/bin_scores_f16.cu", 1e-4, BF16_FLOPS, 1)
    for e in f32_entries + f16_entries:
        e["max_abs_err"] = max(e["max_abs_err"], edge10.get(e["name"], 0.0))
    late_entries.extend(f32_entries + f16_entries)
    del d16, nv16, idx16
    torch.cuda.empty_cache()
    say("store_dtypes_full", smi=smi, rows=N_ROWS, dim=DIM, edge_shape_max_abs_err=edge10,
        kernel2_f32_edge_checks_s=round(edges2_f32_s, 2),
        card_gb_allocated_at_10=card_gb_10,
        card_gb_allocated_at_10c=card_gb_10c, card_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        gen_f32_s=round(gen32_s, 2),
        upload_f32_s=round(up32_s, 2), build_upload_f16_s=round(up16_s, 2),
        f32={"overlap_k1000": ov32[0], "overlap_k100": ov32[1], "max_rank_score_gap": ov32[2],
             "search_s": round(ov32[3], 2), "rescore_overlap_k1000": ov5, "rescore_max_gap": gap5,
             "sketch_build_s": round(sk_build_s, 2), "guaranteed_s": round(grt32_s, 2),
             "guaranteed_ids_equal_exact": True, "f32_sketch_certified_frac": float(fc32.mean()), **tiers32},
        f16={"overlap_k1000": ov16[0], "overlap_k100": ov16[1], "max_rank_score_gap": ov16[2],
             "search_s": round(ov16[3], 2), **tiers16},
        kernels={e["name"]: {"ms": e["ms"], "bound_ms": e["bound_ms"], "max_abs_err": e["max_abs_err"]}
                 for e in late_entries[-7:]},
        launches={k: path_counts[k] for k in ("search_f32", "fused_f32", "adaptive_f32_k100", "rescore_f32",
                                              "sketch_f32_guaranteed", "sketch_f32_sidecar", "search_f16",
                                              "fused_f16", "adaptive_f16_k100", "rescore_f16")})

    # kernel 6 over f16 and f32 doc tokens at the two-stage shape (B = 256,
    # K = 400, Tq = Td = 32, d = 1024)
    q6 = torch.randn(256, TQ, DIM, device=dev, generator=g10k)
    q6 /= q6.norm(dim=-1, keepdim=True)
    qm6 = (torch.rand(256, TQ, device=dev, generator=g10k) < 0.9).to(torch.int32)
    dm6 = (torch.arange(TD, device=dev) < torch.randint(1, TD + 1, (256, K_DENSE, 1), device=dev,
                                                         generator=g10k)).to(torch.int32)
    d6 = torch.empty(256, K_DENSE, TD, DIM, device=dev)
    for b0 in range(0, 256, 32):
        x = torch.randn(32, K_DENSE, TD, DIM, device=dev, generator=g10k)
        d6[b0 : b0 + 32] = x / x.norm(dim=-1, keepdim=True)
    del x
    for dt6 in (torch.float16, torch.float32):
        label = "f16" if dt6 == torch.float16 else "f32"
        dd = d6.to(dt6)
        k6 = msim.maxsim_scores(q6, qm6, dd, dm6)
        p6 = msim.maxsim_scores_plain(q6, qm6, dd, dm6)
        torch.cuda.synchronize()
        err6 = (k6 - p6).abs().max().item()
        check(bool(((k6 - p6).abs() <= TOL_MAXSIM + TOL_MAXSIM_REL * p6.abs()).all()),
              f"6 ({label}) err {err6} at the main shape")
        qd6 = q6.to(dt6)

        def lib_maxsim6():
            s = torch.einsum("bqd,bktd->bkqt", qd6, dd)
            s = s.masked_fill(dm6[:, :, None, :] == 0, -torch.inf).amax(dim=-1).float()
            s = torch.where(qm6[:, None, :] > 0, s, 0.0)
            return torch.where(torch.isfinite(s), s, 0.0).sum(dim=-1)

        esz = dd.element_size()
        passes, peak = (3, TF32_FLOPS) if dt6 == torch.float32 else (1, BF16_FLOPS)
        b_ms, b_by = bound(256 * TQ * DIM * 4 + 256 * TQ * 4 + 256 * K_DENSE * TD * DIM * esz
                           + 256 * K_DENSE * TD * 4 + 256 * K_DENSE * 4,
                           passes * 2 * 256 * K_DENSE * TQ * TD * DIM, peak)
        late_entries.append(dict(
            name=f"maxsim[{label}]", route="cuda", source="codemix_dense_retrieval_torch/csrc/maxsim.cu",
            replaces="codemix_dense_retrieval_tpu/ops/maxsim.py:132", launches=None, max_abs_err=err6,
            max_rel_err=((k6 - p6).abs() / p6.abs().clamp(min=1.0)).max().item(),
            **kernel_ms(lambda: msim.maxsim_scores(q6, qm6, dd, dm6), 5),
            plain_ms=cuda_ms(lambda: msim.maxsim_scores_plain(q6, qm6, dd, dm6), 2),
            bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib_maxsim6, 3),
            shape=f"B=256 K={K_DENSE} Tq={TQ} Td={TD} d={DIM}, f32 queries, {label} doc tokens "
                  f"(library: einsum in {label})",
        ))
        del dd, k6, p6, qd6
    del q6, qm6, dm6, d6
    torch.cuda.empty_cache()

    # 10d. GTE-multilingual-base (12 layers, d=768, 12 heads, FFN 3072, vocab
    # 250,048, rope 160,000; plain attention) and jina-embeddings-v3 (XLM-R
    # at d=1024, 24 layers, 16 heads, FFN 4096, rank-4 LoRA over 5 tasks,
    # non-zero adapters) at full width, random init, bf16
    fam = {}
    texts_d = texts_a[:256]
    passages_d = corpus_texts[:256]
    gcfg = GTEConfig(dtype=torch.bfloat16)
    with torch.device("meta"):
        gmodel = GTEEncoder(gcfg)
    for name, cfg_d, model_d in (("Alibaba-NLP/gte-multilingual-base", gcfg, gmodel),
                                 ("jinaai/jina-embeddings-v3", XLMRConfig.jina_v3(dtype=torch.bfloat16), None)):
        t0 = time.perf_counter()
        enc_d = TextEncoder(name, cfg_d, model=model_d, seed=SEED + 12)
        kernels.reset_launch_counts()
        qv = enc_d.encode_queries(texts_d, batch_size=128)
        pv_d = enc_d.encode_documents(passages_d, batch_size=32, max_length=512)
        pq = enc_d.encode_documents(texts_d, batch_size=128)
        sec = time.perf_counter() - t0
        for x in (qv, pv_d, pq):
            check(x.shape == (256, cfg_d.hidden_size) and bool(np.isfinite(x).all())
                  and bool(np.allclose(np.linalg.norm(x, axis=1), 1.0, atol=2e-2)), f"{name} embeddings")
        role_gap = float(np.abs(qv - pq).max())
        fam[name] = dict(model=type(enc_d.model).__name__, seconds=round(sec, 2),
                         query_task=enc_d._task_id("query"), passage_task=enc_d._task_id("passage"),
                         same_text_query_vs_passage_max_abs=role_gap)
        if name.startswith("jinaai"):
            check(enc_d.cfg.lora_rank == 4 and enc_d.cfg.lora_tasks == 5 and enc_d._task_id("passage") == 1,
                  "jina-v3 task adapters")
            check(role_gap > 1e-3, f"jina-v3 query and passage embeddings of the same texts agree ({role_gap})")
        else:
            try:
                enc_d.encode_documents(passages_d[:4], pack=True)
            except ValueError as e:
                fam[name]["pack_refused"] = str(e)
            check("pack_refused" in fam[name], "GTE accepted pack=True")
        del enc_d
        torch.cuda.empty_cache()
    say("families", smi=smi, **fam, phase10_s=round(time.perf_counter() - t10, 2))

    # ---------------- phase 11: weight quantization, tune, profile ----------------
    mark("11")
    gc.collect()
    torch.cuda.empty_cache()
    phase_11(dev, work, smi, path_counts, texts_a, passages, buckets, corpus_tsv, qdir,
             work / "en.tsv", work / "zh.tsv")

    # ---------------- phase 12: the host tools ----------------
    mark("12")
    gc.collect()
    torch.cuda.empty_cache()
    phase_12(dev, work, smi, path_counts, work / "ckpt", texts_a, texts_b)

    # ---------------- phase 13: multi-device on the one card ----------------
    mark("13")
    gc.collect()
    torch.cuda.empty_cache()
    phase_13(dev, work, smi, path_counts, work / "ckpt", qdir, mix05, docids, passages, buckets)

    # ---------------- phase 14: cover_rescore against kernel A's store ----------------
    mark("14")
    gc.collect()
    torch.cuda.empty_cache()
    late_entries.append(phase_cover_rescore(dev, smi, path_counts))

    # ---------------- phase 15: super_select against its plain version ----------------
    mark("15")
    gc.collect()
    torch.cuda.empty_cache()
    late_entries.append(phase_super_select(dev, smi, path_counts))

    # each kernel's launches over all the paths
    mark("end")
    say("phase_walls", seconds_from_start=walls)
    entries.extend(late_entries)
    for e in entries:
        e["launches"] = total(e["name"].replace("[", "_").rstrip("]"))
        check(e["launches"] > 0, f"{e['name']} never launched on the main path")
    check(trec.WRITES["python"] == 0 and trec.WRITES["native"] > 0 and trec.WRITES["table"] > 0,
          f"TREC runs written by the Python path: {trec.WRITES}")
    say("path_launches", **path_counts)
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase13-worker"]:
        phase_13_worker(sys.argv[2:])
    elif sys.argv[1:2] and sys.argv[1] in ALONE:
        main_alone(sys.argv[1])
    else:
        main()
