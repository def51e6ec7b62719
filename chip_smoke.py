#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rsrgan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases build,kernels_train   # a subset

First the card's ``name, power.limit`` (nvidia-smi), then phases, one
JSON line each; any failure ends the run non-zero:

1. build — compiles every rsrgan_tpu_torch/csrc/*.cu with nvcc for sm_90a
   (one nvcc per source, all started together) and loads them (ctypes).
2. kernel / kernel_small — the wavefront kernel in decode mode (K4,
   save_acts=False, the resident kernel of csrc/resident.cu) against its
   plain twin at res_lstm_l's full width (L=4, U=760, P=257, T=512,
   ragged lengths) at B=16, 1 and 64, in f32 and bf16, with the streaming
   kernel it replaced (csrc/wavefront_fwd.cu) timed beside it; then at
   small odd shapes (SMALL) in both wirings. Every resident case is also
   launched twice and must give the same bits.
3. kernels_train — every training kernel against its plain twin, every
   output stream, in f32 and bf16, at the shapes the train steps give
   it: K4 in train mode (save_acts=True) at G's width, B=16, T=500, and
   at --g_type=lstm's stack (L=3, U=760, P=280, residual off); K1 (the
   D forward, the row-group kernel) at 16 and 32 rows, and at G's width
   (U=760, P=257: res_lstm_l with dropout, res_lstm_i) at 16 and 32 rows
   on its resident route (K4's grid at L = 1), timed beside the
   row-group kernel and the streaming kernel, each launch's route
   checked by lstm_fwd's count by route; K2 at G's
   width (16 rows) and D's (16 rows); K3 at D's width (the row-group walk
   and its reduction) at 32 and 64 rows, and at G's width at B=32, 64,
   128 and 256 (K2's resident walk in acc mode and the reduction), the
   walk and the reduction also timed apart, and the reduction's sums by
   the library beside it (``lstm_weight_grads``'s two f32 einsums on the
   walk's own streams, and a bf16-operand ``torch.matmul`` of the same
   shapes; on the resident and row-group routes); csrc/lstm_bwd.cu for f32 past
   48 rows, where it is faster, the resident walk timed beside where its
   plan fits), each on the route bwd_acc_route names, checked by its
   launch count; the redesigned kernels (K4, K2, K1, K3) also for
   bit-equal relaunches and beside the streaming kernels they replaced.
   Then all four at small odd shapes (U=13, P=9 and U=200, P=40; B=1, 3,
   33 and 64; a zero-length row), K1 also without its saved streams, on
   its resident route launched directly, and at G's width. Then the
   fused optimizer update (csrc/optim.cu, OPTIM_CASES) at the main
   path's leaf shapes: res_lstm_l's G with Adam and clip 15 (also on
   gradients that are views into one flat buffer, as all_reduce_mean
   returns them), LSTM-D with SGD and clip 15, SEGAN's G and D with
   RMSProp and strided convolution gradients; 3 updates against the
   plain path (NetState.apply_plain) given the fused path's norms:
   bit-equal, the norms within 1e-6, after the first update 2 launches
   (FusedUpdate's count; 1 for RMSProp without the clip) and no
   host_wait; both timed on the card and on the host.
4. grad — gradients of the full-width G stack (B=16, and B=32 with K3's
   resident route in every layer) and of D (16 and 32 rows) through the
   kernels' autograd Functions against the eager cell under autograd,
   f32.
5. prepare — Kaldi arks and scp files of 128 seeded train utterances
   (four length buckets of 32: two batches of each at B=16, interleaved
   by the shuffle, so the JAX CLI's update order, which the port
   follows, is not the batcher's) and 16 cv utterances (150-600 frames,
   257 -> 40), every other matrix compressed, and Kaldi CMVN stats,
   written through the port; then ``python -m
   rsrgan_tpu_torch.cli.prepare`` cmvn, make-store (train, cv), split and
   verify-store as processes, each exiting 0; every stored matrix
   bit-equal to the port's read of its ark with the CMVN applied;
   make-store's frames/s.
6. train — from the prepare phase's stores and train_cmvn.npz: one
   epoch of ``rsrgan_tpu_torch.cli.train.main(
   ["--trainer=gan_rnn", "--g_type=res_lstm_l", "--batch_size=16",
   ...])`` with ``--device_feed=off`` (the host feed), then one with the
   default flags on the bf16 kernel path, which on a card feed from the
   resident tables (the main path: every kernel's launch count is reset
   before it and read after it); the two checkpoints and metrics rows
   must be bit-equal, and both feeds' train frames/s and ms per
   iteration are printed on a line of their own; one epoch with
   ``--same_batch=false`` (the graph-fed loop) and one with
   ``--d_conditioned=true``, each with finite losses and on the kernel
   routes (launch counts); one with ``--keep_prob=0.8`` (G per layer: K1
   at G width 4 x 3 times an iteration past the main path's launches,
   all on K1's resident route, K2 backward, no K4 train launch; its ms
   per iteration beside the main path's and beside the epoch's time with
   K1 at G width on the row-group kernel); one with
   ``--g_type=res_lstm_i`` (G's 2 layers always per layer: K1 at G width
   on the resident route for every G forward and cv batch, K2 backward,
   no K4) and ``--decode`` from its checkpoint (K1 without its saved
   streams, 2 a batch), then K1 and K2 at every G-width shape the two
   launched against their twins in f32 and bf16; one with
   ``--g_type=lstm`` (K4 train at P=280, two
   launches an iteration) and ``--decode`` from its checkpoint; two with
   ``--checkpoint_every_secs=1`` and the default ``--tensorboard`` (the
   event files' records and steps against metrics_*.jsonl, the periodic
   snapshot read back by load_newest_state) and ``--profile_dir`` (one
   torch.profiler trace, of the second iteration, holding the resident
   kernels' events); decode from the main path's
   checkpoint; one
   f32 train step on one batch through the kernels against
   --lstm_impl=scan; and one bf16 train step at T=600 under
   torch.profiler (device time by kernel, device busy share; the D
   step's backward must show on K3's row-group kernels and not on
   csrc/lstm_bwd.cu), then one at B=32, the CLI's default (the 32
   longest utterances): its 8 G-layer backwards on K3's resident route
   (counts set to 0 just before the step), none on csrc/lstm_bwd.cu;
   then the peak device memory of one bf16 step at B=64, T=600, which
   must stay below the device feed's reserve (FEED_RESERVE_BYTES).
7. train_mse — ``--trainer=rnn --g_type=res_lstm_l`` (the MSE trainer,
   G alone; recipes/run_rnn.sh's B=16 and learning rate) through the CLI
   from the same stores: one epoch on the device feed (the main path of
   this trainer: counts set to 0 just before, read after; each iteration
   one K4 train launch and one K2 launch per G layer, no K1 and no K3),
   its ms per iteration and train frames/s beside the flagship's; one
   on the host feed before it and one after, checkpoints and metrics
   bit-equal to it; one with ``--keep_prob=0.8`` (G per layer: K1 at G
   width on its resident route and K2, once per layer an iteration, no
   K4 train; the cv pass on K4 decode), its ms per iteration, and K1 and
   K2 at every G-width shape it launched against their twins; one at
   B=32,
   every G-layer backward on K3's resident route and none on
   csrc/lstm_bwd.cu; one f32 step through the kernels against
   --lstm_impl=scan (gradients and post-step params, GRAD_TOL); and
   ``--decode`` from the epoch's checkpoint. Then ``--g_type=bnlstm``
   (recipes/run_rnn.sh's bnlstm arm: 3 x BnLstm(760, proj 280), the
   eager cell, no hand kernel): one epoch at B=16 through the CLI (all 8
   iterations; every hand kernel's count 0 over it), its ms per
   iteration, the CUDA kernels and copies of one train step on the
   longest bucket (torch.profiler), the f32 step on the card against the
   same step on the CPU from one state (gradients, the state after it
   with the folded batch_stats, the losses; GRAD_TOL), and ``--decode``
   from the epoch's checkpoint.
8. train_frame — the frame trainers through the CLI in f32, with TF32
   turned on for the process before each run so that only the CLI's own
   setting turns it off: ``--trainer=dnn`` and ``--trainer=gan_dnn`` at
   the recipes' width (4 x 1024 on 11 spliced 257-dim frames, 40 out,
   B=256) for one epoch of the train store, ``--g_type=rced`` and
   ``--g_type=cnn`` at full width for one epoch of the 16-utterance cv
   store; each with finite losses, a checkpoint, ``--decode`` from it
   and its frames/s; then the DNN's (256 rows) and R-CED's (8 rows) f32
   step on the card against the same step on the CPU (G's output and
   the last layer's gradients, FRAME_STEP_TOL), and the DNN's step with
   TF32 on, which that gate must catch.
9. segan — ``--trainer=segan`` at recipes/run_segan.sh's configuration
   (the conv auto-encoder G, kwidth 20, depths 16..1024; the VBN conv D,
   kwidth 31; 7 spliced 257-dim frames to 40; B=256; RMSProp; L1 weight
   100), f32: one train step on the card against the same step on the
   CPU from one state, z and D's noise handed in (G's forward and D's
   losses at SEGAN_FORWARD_TOL; every gradient, the state after the step
   and G's losses at SEGAN_STEP_TOL, the f32 step's own distance from
   f64 taken into account); one
   epoch through the CLI over the train store's frames with labels G
   can learn (``segan_stores``), accepted, finite losses, no hand kernel,
   TF32 off after it; ``--decode`` from its checkpoint; ms per
   iteration, frames/s and the busy share of 3 profiled steps; then the
   WaveNet-style G's step (64 rows) against the CPU.
10. parallel — data parallelism (rsrgan_tpu_torch/parallel) from the
   prepare phase's stores: whether MPS is on (nvidia-smi -q); (a) the
   flagship step (res_lstm_l G and LSTM-D at full width, f32, on the
   kernels) on two ranks sharing the card over gloo, each on its 8 rows
   of a 16-row batch, against the one-process step at 16 rows on the
   card (the 3 updates' gradients and D's post-step params,
   GRAD_TOL), each rank's launches on the local-row routes (K2 at 8 and
   16 rows where the one process takes K3 at 32: PAR_RANK_LAUNCHES), ms
   per step of each rank and its collectives' share (two ranks
   time-slicing one card, not scaling); (b) recipes/run_gan_rnn.sh's
   flags at --batch_size=8, bf16, one epoch, as two processes
   (--coordinator_address): only rank 0 writes (one checkpoint, one
   metrics row and events file per split), finite losses, the LOG line
   names gloo, and --decode reads the checkpoint back; (c) its f32
   decode by two processes against the one-process decode, max abs <=
   DECODE_TOL_F32; (d) with two or more cards, (a) over NCCL and a
   --num_gpu=2 epoch, else a line saying why not (not a pass).
11. feed — a seeded store of ~1.7 M frames (~2 GB of f32 tables): the
   upload of its f32 and bf16 tables (GB/s over the f32 bytes that cross
   the link, twice each, and the reference corpus's ~36 M frames
   extrapolated from it); the gather of one batch at B=16 and 32,
   T_pad=600, against SequenceBatcher._make_batch plus pageable copies
   of the same indices (bit-equal); the rotating feed over 1,200 of its
   utterances under a small RSRGAN_FEED_HBM_BUDGET (>= 3 shards,
   prefetch on, block 1, two passes, each residency's gathers queued
   behind a device sleep), every gathered batch bit-equal to the host
   batch of its shard's StoreView batcher.
12. decode — a seeded full-width res_lstm_l checkpoint, a 32-utterance
   test store, ``cli.train.main(["--decode", ...])`` at
   --decode_batch_size=16 on the default bf16 kernel path (the decode
   path: its launch count is reset before and read after), and f32 runs
   of the kernel and of --lstm_impl=scan held against each other.
13. chain — the recipes' chains through the port's CLIs. First the
   features on the card: ``import scipy`` and its version; the waves of
   tests/fixtures/oracle_feats.npz and dsp_golden.npz through
   ``cli/extract.py``'s engine on the card at dither 0, gated at the
   float32 contract (LPS power, log domain above 1e-6 of the peak,
   energy slot; MFCC by wave) and held against the same stack on the
   CPU; ``extract.main`` with dither at --batch_size=16 and 1 on a
   40-utterance corpus, bit-equal, with TF32 turned on before each run
   and found off after. Then ``tools/e2e_chain.run_chain`` for
   ``--target=lps`` (recipes/run_enhance_demo.sh: assets, simulate,
   extract, prepare, train gan_rnn res_lstm_l at B=4, decode, resynth,
   score, the LSD gate) and ``--target=mfcc`` (recipes/run_e2e_sim.sh:
   the two MSE gates), each at 96 utterances and 12 epochs; every launch
   count set to 0 just before each chain's train and decode stage and
   read just after, in total and by shape (``shape_key``: the sizes
   that choose a kernel's plan): K4 train, K1 and K2 in train, K4 decode
   in decode, and K3 in neither (every backward there has 4 or 8 rows,
   below ACC_BWD_MIN_BATCH). Stage seconds, train and extraction
   frames/s, the gates' numbers. Then each kernel at every shape the
   chains launched it at (T=300, ragged rows) against its twin, f32 and
   bf16, at the kernel phases' tolerances.

14. serve — the streaming front-end (serving/, cli/serve.py) at
   res_lstm_l's full width, f32, the eager cell (no hand kernel: every
   launch count is 0 while streaming). Feature mode: ``cli.serve.main``
   over the decode phase's 32 utterances at --chunk_frames=50, from a
   whole seeded GanState checkpoint, against ``cli.train --decode`` in
   f32 on K4 (its K4 launches counted) and on --lstm_impl=scan, max abs
   <= 1e-3; at --chunk_frames=7 and 640 (longer than every utterance)
   bit-equal to it on 8 utterances; TF32 turned on before each CLI run
   and found off after; ms per 50-frame chunk at B=1 (median and p95 of
   200) and per pooled step at B=8 (50), with torch.profiler's CUDA
   kernels and copies per chunk and the device's busy share. Wav mode:
   an LPS->LPS res_lstm_l (257 out) and the waves' own CMVN over 16
   seeded noisy waves of 2-4 s; the CLI single-stream and at
   --num_streams=8 (its x-realtime lines; the written wavs equal up to
   one 16-bit step, the single stream's bit-equal to the library's
   float waves clipped to 16 bits), the library's float waves pooled
   against single within 1e-5 of the peak and against the offline chain
   (f32 --decode, then resynthesize) above 35 dB SNR.
15. tools — the port's measurement tools (rsrgan_tpu_torch/tools), each
   as a process on the card with its launch counts set to 0 before it
   and written after it (``counted_tool``): ``kernel_bench`` and
   ``profile_step`` at their defaults (full width, B=16, T=500, bf16),
   ``serve_bench`` at 20 chunks a configuration, ``io_bench`` at its
   defaults; each must exit 0, print the card's ``name, power.limit``
   first and then the JAX tool's lines (every segment's ms; the
   profile's 10 step ranges, busy share, the five hand kernels of the
   flagship step as kernel rows and the host time by port function;
   the latency grid, with no hand-kernel launch; every io stage's
   rate), all on a ``tools`` line. Every shape the kernel tools
   launched (each wrapper's ``launches_by_shape``) is held against its
   twin in f32 and bf16: anew (T=500, ragged rows) where no earlier
   phase (kernel, kernels_train, chain, parallel) held it, and listed
   with ``launches_tools``.
16. proxy — ``tools.proxy_asr.main`` on the card over
   tests/test_proxy.py's separable corpus and its noisy twin, with that
   test's gates (clean FER < 0.25, noisy FER > clean + 0.1, SER <= FER +
   0.35), TF32 off after, its train frames/s, no hand kernel; then one
   f32 step at hidden 192 on the card against the same step on the CPU
   from the same weights: gradients per tensor and the post-step
   parameters, max |diff| / max |ref| <= 1e-5.
17. experiments — the experiment recipes through
   ``rsrgan_tpu_torch.tools.experiments`` at full width (res_lstm_l and
   LSTM-D, bf16, --batch_size=8), each with TF32 turned on before it and
   found off after, every launch count set to 0 just before each stage
   and read just after (in total and by shape): ``ablation`` at
   EXP_UTTS utterances (the recipe's assets, EXP_VAL held out, seeds 777
   and 778 at weight 10, EXP_EPOCHS a system after the warm-up epoch;
   its table's gate at EXP_GATE_ENV, the proxy FER of every trained
   system below the noisy FER, the two seeds' systems different);
   ``ablation_mfcc`` and ``ema_check`` (EXP_EMA_ITERS iterations; both
   decodes finite, one metrics row an iteration; the verdict printed,
   not gated) on its corpus; ``ref_scale`` at EXP_REF_UTTS utterances in
   two calls (stages 0-3, then 4-8 with an RSRGAN_FEED_HBM_BUDGET that
   cuts the train tables into >= EXP_REF_SHARDS shards: more than one
   residency a system); ``synth_quality`` at its own size (B=4, 24
   iterations, its 0.5 x mean gate); ``micro`` (recipes/run_micro.sh
   stages -1 to 3 at its own size: 24 utterances, B=2, up to 2 epochs;
   its check: 6 decoded utterances, 40-dim, finite). Train stages on K4
   train, K1 (not the MSE trainer's), K2; decode stages on K4 decode;
   K3 nowhere. Then each kernel at every shape the recipes launched
   (T=EXP_T, ragged rows) against its twin, f32 and bf16.

Every CLI training run (``with_optim_counts``) arms the spans and counts
the fused optimizer's launches and its updates on each path: one update
on the plain path on the card fails the run (only the tensor-parallel
steps of the parallel phase take it, by design).

Then a "timing" line (each phase's wall seconds and the total), a
{"kernels": [...]} line (one entry more per shape the chains, the
data-parallel ranks, the measurement tools and the experiment recipes
launched, and one per net of the fused optimizer's check, its launches
from the train and segan phases' epochs, with ``launches_chain``,
``launches_parallel``,
``launches_tools`` or ``launches_experiments``, its launches at that
shape in each run; null on the other entries; K3's entries with
``library_ms`` and ``library_bf16_ms``, its reduction by the library
beside ``reduction_ms``), the
card's ``name, power.limit``, and last {"ok": true, "device": {...}}.
Without a CUDA device, or without the rest of the repository beside it,
it fails and prints no result.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
RESIDENT = "rsrgan_tpu_torch/csrc/resident.cu"
REPLACES = "rsrgan_tpu/ops/pallas_wavefront.py:48"
# the two bf16 instantiations of the resident walk, as the profiler names
# them: K2, and K3's walk in acc mode
K2_BF16_KERNEL = "lstm_bwd_resident_kernel<__nv_bfloat16, false>"
K3_WALK_BF16_KERNEL = "lstm_bwd_resident_kernel<__nv_bfloat16, true>"

# res_lstm_l at full width; B is bench.py's batch, T a 128-padded length
L, U, P, OUT = 4, 760, 257, 40
# --g_type=lstm: Dense 257 -> 280, 3 x LSTM(760, proj 280), Dense 280 -> 40
LSTM_P = 280
B, T = 16, 512
LENGTHS = [512, 497, 301, 150, 384, 511, 256, 199,
           420, 128, 333, 480, 275, 64, 448, 1]

# Tolerances, kernel vs twin on the same card. Both accumulate in f32 and
# differ only in summation order (8-way split of the 257- and 760-long
# dots, then a tree of partials), so in f32 the gap is rounding noise,
# carried through T+L-1 = 515 dependent steps: 1e-4 on outputs of order
# 1-10 is ~1000x below one bf16 ulp. In bf16 both round the same
# operands, but a last-bit f32 difference can flip a bf16 rounding of h
# or m (one bf16 ulp = 2^-8 relative), which then propagates: 2e-2.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# f32 decode, kernel vs eager scan cell: the same f32 math with other
# summation orders, through the dense layer and CMVN denormalisation.
DECODE_TOL_F32 = 1e-3

# The train step's shapes: bench.py's batch B=16 at T=500; D is
# 2 x LSTM(256, proj 40) on 40-dim frames, at B rows (G steps) and 2B
# rows (the D step stacks real and fake).
TT = 500
TRAIN_LENGTHS = [500, 497, 301, 150, 384, 411, 256, 199,
                 420, 128, 333, 480, 275, 64, 448, 1]
DU, DP = 256, 40
# Training kernels vs their twins, every stream, gated at
# TOL[dtype] * max(1, max |twin|): the backward streams and the weight
# gradients (sums over T*B = 8,000 rows) reach magnitudes of 10-100, and
# their f32 summation-order noise grows with them.
# f32 gradients, kernels' autograd Functions vs the eager cell under
# autograd (grad phase) and kernel vs scan train step (train phase):
# max |diff| / max |ref| per tensor. The same f32 math in other orders
# through 500 dependent steps and 8,000-row sums gives ~1e-5; a pairing
# or masking fault gives O(1).
GRAD_TOL = 1e-3
K3_GRADS = ("dxw", "dwh", "dproj", "dbias", "dwi", "dwf", "dwo")
# The batches at which K3 runs at G's width: the CLI's default 32, 64, 128
# and bench.py's 256 (the recipe's 8 takes K2)
K3_G_BATCHES = (32, 64, 128, 256)
# Published peaks of one H100 SXM (dense), for the bounds.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def glorot(rng, shape):
    limit = np.sqrt(6.0 / (shape[0] + shape[1]))
    return rng.uniform(-limit, limit, size=shape).astype(np.float32)


def generator_tree(seed: int, out: int = OUT) -> dict:
    """Seeded res_lstm_l G parameters (``out`` wide) in the JAX tree
    layout."""
    rng = np.random.default_rng(seed)
    tree = {}
    for k in range(L):
        tree[f"lstm_cell_{k + 1}"] = {
            "kernel": glorot(rng, (2 * P, 4 * U)),
            "bias": rng.normal(0, 0.1, 4 * U).astype(np.float32),
            "proj_kernel": glorot(rng, (U, P)),
            "w_i_diag": glorot(rng, (1, U)),
            "w_f_diag": glorot(rng, (1, U)),
            "w_o_diag": glorot(rng, (1, U)),
        }
    tree["forward_out"] = {"kernel": glorot(rng, (P, out)),
                           "bias": rng.normal(0, 0.1, out).astype(np.float32)}
    return tree


def cuda_time_ms(fn, reps: int) -> float:
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> dict:
    from rsrgan_tpu_torch.ops import _build
    t0 = time.monotonic()
    libs = _build.load_all()
    info = {name: _build.BUILD_LOG.get(name, {}) for name in libs}
    out = {"phase": "build", "ok": True,
           "seconds": round(time.monotonic() - t0, 3),
           "nvcc_seconds": {n: i.get("seconds") for n, i in info.items()},
           "libraries": {n: lib._name for n, lib in libs.items()},
           "nvcc": _build.find_nvcc(), "flags": _build.NVCC_FLAGS,
           "ptxas": {n: [ln.strip() for ln in i.get("ptxas", "").splitlines()
                         if "registers" in ln or "spill" in ln]
                     for n, i in info.items()}}
    emit(out)
    return out


def kernel_inputs(seed, L_, U_, P_, B_, T_, lengths, cdt, device):
    """Kernel arguments as lstm_stack_wavefront prepares them."""
    import torch
    from rsrgan_tpu_torch.ops.wavefront_stack import _prep
    rng = np.random.default_rng(seed)
    params = [{"kernel": glorot(rng, (2 * P_, 4 * U_)),
               "bias": rng.normal(0, 0.1, 4 * U_).astype(np.float32),
               "proj_kernel": glorot(rng, (U_, P_)),
               "w_i_diag": glorot(rng, (1, U_)),
               "w_f_diag": glorot(rng, (1, U_)),
               "w_o_diag": glorot(rng, (1, U_))} for _ in range(L_)]
    params = [{k: torch.from_numpy(v).to(device) for k, v in p.items()}
              for p in params]
    x = torch.from_numpy(rng.normal(size=(T_, B_, P_)).astype(np.float32))
    x = x.to(device)
    wx, wh, bias, proj, wi, wf, wo = _prep(params, P_, 1.0)
    wx, wh, proj = (a.to(cdt).contiguous() for a in (wx, wh, proj))
    xw1 = torch.matmul(x, wx[0].float()).to(cdt)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return (xw1, lens, x, wx[1:].contiguous(), wh, proj, bias.contiguous(),
            wi.contiguous(), wf.contiguous(), wo.contiguous())


def same_bits(fn) -> bool:
    """Two launches on the same inputs give bit-equal outputs."""
    import torch
    a, b = fn(), fn()
    a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
    return all(torch.equal(x, y) for x, y in zip(a, b))


def resident_grid(plan) -> dict:
    return {"grid": plan.blocks, "design": "resident",
            "smem_bytes": plan.smem,
            "weights_resident": plan.weights_resident()}


def rowgroup_grid(plan) -> dict:
    return {"grid": plan.groups, "design": "rowgroup",
            "group_rows": plan.group_rows, "smem_bytes": plan.smem,
            "weights_resident": plan.weights_resident()}


def k1_grid(B_, U_, P_, cdt, sms) -> dict:
    """K1's launch at these sizes on the route ``fwd_route`` names: the
    row-group kernel's groups, or K4's resident grid at L = 1."""
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    from rsrgan_tpu_torch.ops import wavefront as wf
    route = ls.fwd_route(B_, U_, P_, cdt, sms)
    if route == "rowgroup":
        return rowgroup_grid(ls.rowgroup_plan(B_, U_, P_, cdt, sms))
    plan = wf.resident_plan(B_, 1, U_, P_, cdt, sms)
    return {**resident_grid(plan), "K": plan.Kp}


def k1_route_check(route: str, calls: int):
    """A ``timed`` check: the next ``calls`` calls of lstm_fwd (1 + the
    timed launches + 2 relaunches) all took ``route``."""
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    before = dict(ls.lstm_fwd.launches_by_route)
    return lambda: (ls.lstm_fwd.launches_by_route.get(route, 0)
                    == before.get(route, 0) + calls
                    and sum(ls.lstm_fwd.launches_by_route.values())
                    == sum(before.values()) + calls)


def phase_kernel(dtype_name: str) -> dict:
    """K4 decode at B=16 (the main path's batch), then B=1 and B=64
    (--decode_batch_size 1 and 64), each against its twin; the streaming
    kernel (csrc/wavefront_fwd.cu) timed on the same inputs at B=16."""
    import torch
    from rsrgan_tpu_torch.ops import wavefront as wf
    cdt = getattr(torch, dtype_name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"phase": "kernel", "dtype": dtype_name, "L": L, "U": U, "P": P,
           "T": T, "tol": TOL[dtype_name], "by_batch": {}}
    ok = True
    for rows in (B, 1, 64):
        lens = (LENGTHS * 4)[:rows]
        args = kernel_inputs(1, L, U, P, rows, T, lens, cdt, "cuda")
        run = lambda: wf.lstm_wavefront_fwd(*args, residual=True)  # noqa
        got = run()
        torch.cuda.synchronize()
        want = wf.lstm_wavefront_fwd_reference(*args, residual=True)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        finite = bool(torch.isfinite(got).all())
        r = {"max_abs_err": err, "max_abs_ref": float(want.abs().max()),
             "ms": cuda_time_ms(run, 10), "finite": finite,
             "deterministic": same_bits(run),
             **resident_grid(wf.resident_plan(rows, L, U, P, cdt, sms))}
        if rows == B:
            r["plain_ms"] = cuda_time_ms(
                lambda: wf.lstm_wavefront_fwd_reference(*args,
                                                        residual=True), 1)
            r["streaming_ms"] = cuda_time_ms(
                lambda: wf._launch(*args, residual=True, save_acts=False), 5)
            out.update(B=B, **r)
        out["by_batch"][rows] = r
        ok = ok and finite and err <= TOL[dtype_name] and r["deterministic"]
    out["ok"] = ok
    emit(out)
    return out


# Odd shapes of the resident kernels: U and P not multiples of the mma
# tiles, units that do not divide the grid evenly (200 over 33 blocks per
# layer), B = 1, 3, 33 and 64, L = 1 and 3 without the residual.
SMALL = [(4, True, 13, 9, 3), (3, False, 13, 9, 3), (1, False, 13, 9, 1),
         (4, True, 200, 40, 33), (3, False, 200, 40, 64),
         (1, True, 200, 40, 3)]


def phase_kernel_small() -> dict:
    """K4 decode mode at the SMALL shapes, every length row ragged and one
    of length 0, f32, each also checked for bit-equal relaunches."""
    import torch
    from rsrgan_tpu_torch.ops.wavefront import (lstm_wavefront_fwd,
                                                lstm_wavefront_fwd_reference)
    errs, ok = {}, True
    for L_, residual, U_, P_, B_ in SMALL:
        args = kernel_inputs(2, L_, U_, P_, B_, 17, ([17, 11, 0] * 22)[:B_],
                             torch.float32, "cuda")
        run = lambda: lstm_wavefront_fwd(*args, residual=residual)  # noqa
        got = run()
        want = lstm_wavefront_fwd_reference(*args, residual=residual)
        torch.cuda.synchronize()
        tag = f"L{L_}_residual_{residual}_U{U_}_B{B_}"
        errs[tag] = float((got - want).abs().max())
        ok = ok and errs[tag] <= 1e-5 and same_bits(run)
    out = {"phase": "kernel_small", "max_abs_err": errs, "tol": 1e-5,
           "ok": ok}
    emit(out)
    return out


def bound(flops: float, nbytes: float, dtype_name: str) -> dict:
    """The least time the card could take: the larger of operations over
    the peak rate of their type and bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def true_steps(lengths, T_) -> int:
    return int(sum(min(int(n), T_) for n in lengths))


# The bounds' byte counts read each input stream once at the true row-steps
# only (a masked step needs no input: its outputs are zeros or the carried
# state) and write each output once in full, masked rows included.


def wavefront_bound(L_, U_, P_, B_, T_, lengths, dtype_name, train,
                    residual=True):
    """K4: per true row-step and layer, h·W_h (and in·W_x above layer 1)
    and m·proj. Bytes: weights, xw1 at the true row-steps, lengths, with
    the residual wiring (res_lstm_l) x at every row (the tap of a masked
    row is x itself); out: the top tap (decode) or the saved streams
    (train)."""
    G_, wb = 4 * U_, 2 if dtype_name == "bfloat16" else 4
    n = true_steps(lengths, T_)
    flops = n * (L_ * 2 * P_ * G_ + (L_ - 1) * 2 * P_ * G_ + L_ * 2 * U_ * P_)
    nbytes = (((2 * L_ - 1) * P_ * G_ + L_ * U_ * P_) * wb
              + L_ * (G_ + 3 * U_) * 4 + n * G_ * wb + B_ * 4
              + (T_ * B_ * P_ * 4 if residual else 0))
    if train:
        nbytes += L_ * T_ * B_ * ((2 * P_ + U_) * 4 + G_ * wb)
    else:
        nbytes += T_ * B_ * P_ * 4
    return bound(flops, nbytes, dtype_name)


def k1_bound(U_, P_, B_, T_, lengths, dtype_name):
    """K1: weights, xw at the true row-steps, lengths; out, c_hist,
    h_hist and acts written in full."""
    G_, wb = 4 * U_, 2 if dtype_name == "bfloat16" else 4
    n = true_steps(lengths, T_)
    flops = n * (2 * P_ * G_ + 2 * U_ * P_)
    nbytes = ((P_ * G_ + U_ * P_) * wb + (G_ + 3 * U_) * 4 + B_ * 4
              + n * G_ * wb + T_ * B_ * (G_ * wb + (2 * P_ + U_) * 4))
    return bound(flops, nbytes, dtype_name)


def bwd_bound(U_, P_, B_, T_, lengths, dtype_name, acc):
    """K2: per true row-step dh_total·projᵀ and dgates·W_hᵀ; K3 adds the
    weight-gradient products h(t-1)ᵀ·dgates and mᵀ·dh. Bytes: weights,
    peepholes, lengths, and acts, dout, c_hist (K3: h_hist) at the true
    row-steps; dxw (K2: m, dh; K3: the weight gradients) written."""
    G_, wb = 4 * U_, 2 if dtype_name == "bfloat16" else 4
    n = true_steps(lengths, T_)
    flops = n * (2 * P_ * U_ + 2 * G_ * P_)
    nbytes = ((P_ * G_ + U_ * P_) * wb + 3 * U_ * 4 + B_ * 4
              + n * (G_ * wb + P_ * 4 + U_ * 4)   # acts, dout, c_hist
              + T_ * B_ * G_ * wb)                # dxw
    if acc:
        flops += n * (2 * P_ * G_ + 2 * U_ * P_)
        nbytes += n * P_ * 4 + (P_ * G_ + U_ * P_ + G_ + 3 * U_) * 4
    else:
        nbytes += T_ * B_ * (U_ + P_) * wb        # m, dh
    return bound(flops, nbytes, dtype_name)


def layer_params(rng, D_, U_, P_, cdt, device):
    """One seeded LSTM layer as the single-layer kernels take it: w_x
    [D, G] f32, w_h [P, G] and proj [U, P] in W, bias [G] with
    forget_bias folded, peepholes [U]."""
    import torch
    from rsrgan_tpu_torch.ops.lstm_seq import fold_forget_bias
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    kernel = glorot(rng, (D_ + P_, 4 * U_))
    return {"w_x": t(kernel[:D_]),
            "w_h": t(kernel[D_:]).to(cdt).contiguous(),
            "proj": t(glorot(rng, (U_, P_))).to(cdt).contiguous(),
            "bias": fold_forget_bias(
                t(rng.normal(0, 0.1, 4 * U_).astype(np.float32)), 1.0),
            "wi": t(glorot(rng, (1, U_))[0]), "wf": t(glorot(rng, (1, U_))[0]),
            "wo": t(glorot(rng, (1, U_))[0])}


def compare_streams(names, got, want, dtype_name, tol=None):
    """max |got - want| per stream, each gated at tol * max(1, max|want|)."""
    tol = TOL[dtype_name] if tol is None else tol
    errs, refs, ok = {}, {}, True
    for name, g, w in zip(names, got, want):
        errs[name] = float((g.float() - w.float()).abs().max())
        refs[name] = float(w.float().abs().max())
        finite = bool(torch_isfinite(g))
        ok = ok and finite and errs[name] <= tol * max(1.0, refs[name])
    return errs, refs, ok


def torch_isfinite(t) -> bool:
    import torch
    return bool(torch.isfinite(t.float()).all())


def timed(name, dtype_name, fn, twin, names, reps=5, tol=None,
          streaming=None, steps=None, check=None, faster_than=(), **extra):
    """Run kernel and twin on the same inputs, compare every stream, time
    both (kernel over ``reps`` launches, twin over its one run); a
    redesigned kernel
    (``streaming``: the kernel it replaced, which streams its weights
    from L2, on the same inputs) is also checked for bit-equal relaunches
    and timed beside it; with ``steps`` (the recurrence's length) also µs
    per step; with ``check`` (read after every launch) also that the calls
    took the kernel they should; with ``faster_than`` (keys of ``extra``
    or "streaming_ms") also that the kernel beat each of those times; emit
    the phase."""
    import torch
    got = fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = twin()   # run once: compared and timed
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    errs, refs, ok = compare_streams(names, got, want, dtype_name, tol)
    ms = cuda_time_ms(fn, reps)
    if streaming is not None:
        extra["deterministic"] = same_bits(fn)
        extra["streaming_ms"] = cuda_time_ms(streaming, reps)
        ok = ok and extra["deterministic"]
    if steps:
        extra["us_per_step"] = ms * 1e3 / steps
    if check is not None:
        extra["route_ok"] = check()
        ok = ok and extra["route_ok"]
    if faster_than:
        extra["faster_than"] = {k: ms < extra[k] for k in faster_than}
    out = {"phase": "kernels_train", "kernel": name, "dtype": dtype_name,
           **extra, "max_abs_err": errs, "max_abs_ref": refs,
           "tol": TOL[dtype_name] if tol is None else tol,
           "ms": ms, "plain_ms": plain_ms, "ok": ok}
    emit(out)
    return out


def streaming_bwd(acts, lengths, dout, c_hist, w_h, proj, wi, wf, wo):
    """The streaming K2 kernel (csrc/lstm_bwd.cu, acc=0), for timing
    beside the resident one."""
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    return ls._launch_bwd(acts, lengths, dout, c_hist, None, w_h, proj, wi,
                          wf, wo, acc=False)


def streaming_fwd(xw, lengths, w_h, proj, bias, wi, wf, wo):
    """The streaming K1 kernel (csrc/wavefront_fwd.cu at L = 1, residual
    off), for timing beside the row-group one: (out, c_hist, h_hist,
    acts)."""
    import torch
    from rsrgan_tpu_torch.ops import wavefront
    T_, B_, _ = xw.shape
    P_ = proj.shape[1]
    args = (xw, lengths, xw.new_empty((T_, B_, P_), dtype=torch.float32),
            w_h.new_empty((0, P_, w_h.shape[1])), w_h[None], proj[None],
            bias[None], wi[None], wf[None], wo[None])
    taps, c_hist, h_hist, acts = wavefront._launch(
        *(a.contiguous() for a in args), residual=False, save_acts=True)
    return taps[0], c_hist[0], h_hist[0], acts[0]


def phase_kernels_train(dtype_name: str) -> list:
    """K4 train mode (res_lstm_l's stack, and lstm's: L=3, P=280, residual
    off), K1 (D, and G's width as dropout runs it), K2 (G and D) and K3
    (D, and G at B=32, 64, 128 and 256) at the train steps' shapes."""
    import torch
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    from rsrgan_tpu_torch.ops import wavefront as wf
    from rsrgan_tpu_torch.ops.wavefront import (lstm_wavefront_fwd_reference,
                                                lstm_wavefront_fwd_train)
    cdt = getattr(torch, dtype_name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = []
    streams4 = ("taps", "c_hist", "h_hist", "acts")
    args = kernel_inputs(5, L, U, P, B, TT, TRAIN_LENGTHS, cdt, "cuda")
    r = timed("wavefront_fwd_train", dtype_name,
              lambda: lstm_wavefront_fwd_train(*args, residual=True),
              lambda: lstm_wavefront_fwd_reference(*args, residual=True,
                                                   save_acts=True),
              streams4,
              streaming=lambda: wf._launch(*args, residual=True,
                                           save_acts=True),
              L=L, U=U, P=P, B=B, T=TT,
              **resident_grid(wf.resident_plan(B, L, U, P, cdt, sms)),
              **wavefront_bound(L, U, P, B, TT, TRAIN_LENGTHS, dtype_name,
                                train=True))
    results.append(r)

    # K4 in train mode at LstmGenerator's stack (--g_type=lstm): L=3,
    # U=760, P=280, residual off
    lstm_args = kernel_inputs(15, 3, U, LSTM_P, B, TT, TRAIN_LENGTHS, cdt,
                              "cuda")
    results.append(timed(
        "wavefront_fwd_train", dtype_name,
        lambda: lstm_wavefront_fwd_train(*lstm_args, residual=False),
        lambda: lstm_wavefront_fwd_reference(*lstm_args, residual=False,
                                             save_acts=True),
        streams4,
        streaming=lambda: wf._launch(*lstm_args, residual=False,
                                     save_acts=True),
        net="G_lstm", L=3, U=U, P=LSTM_P, B=B, T=TT,
        **resident_grid(wf.resident_plan(B, 3, U, LSTM_P, cdt, sms)),
        **wavefront_bound(3, U, LSTM_P, B, TT, TRAIN_LENGTHS, dtype_name,
                          train=True, residual=False)))

    # K2 at G's width on layer 1 of the training forward's streams
    taps, c_s, h_s, acts = lstm_wavefront_fwd_train(*args, residual=True)
    rng = np.random.default_rng(6)
    lens = args[1]
    dout = torch.from_numpy(
        rng.normal(size=(TT, B, P)).astype(np.float32)).cuda()
    _, _, _, wh, proj, _, wi, wf, wo = args[1:]
    g_args = (acts[0], lens, dout, c_s[0], wh[0], proj[0], wi[0], wf[0],
              wo[0])
    results.append(timed(
        "lstm_bwd", dtype_name, lambda: ls.lstm_bwd(*g_args),
        lambda: ls.lstm_bwd_reference(*g_args), ("dxw", "m", "dh"),
        streaming=lambda: streaming_bwd(*g_args), net="G", U=U, P=P, B=B, T=TT,
        **resident_grid(ls.resident_plan(B, U, P, cdt, sms)),
        **bwd_bound(U, P, B, TT, TRAIN_LENGTHS, dtype_name, acc=False)))

    # K1 at G's width, as dropout and res_lstm_i run G per layer: B=16
    # (bench.py) and 32 (the CLI's default), on the resident route (K4's
    # grid at L = 1), timed beside the row-group kernel and the streaming
    # kernel on the same inputs
    for rows in (B, 2 * B):
        rng = np.random.default_rng(20 + rows)
        g_lens = (TRAIN_LENGTHS * 2)[:rows]
        prm = layer_params(rng, P, U, P, cdt, "cuda")
        x = torch.from_numpy(
            rng.normal(size=(TT, rows, P)).astype(np.float32)).cuda()
        xw = (x.to(cdt).float() @ prm["w_x"].to(cdt).float()).to(cdt)
        k1_args = (xw, torch.tensor(g_lens, dtype=torch.int32, device="cuda"),
                   prm["w_h"], prm["proj"], prm["bias"], prm["wi"],
                   prm["wf"], prm["wo"])
        rowgroup = lambda: ls._launch_fwd_rowgroup(  # noqa: E731
            *k1_args, save_acts=True)
        rowgroup_errs, _, rowgroup_ok = compare_streams(
            streams4, rowgroup(), ls.lstm_fwd_reference(*k1_args),
            dtype_name)
        r = timed(
            "lstm_fwd", dtype_name, lambda: ls.lstm_fwd(*k1_args),
            lambda: ls.lstm_fwd_reference(*k1_args), streams4,
            streaming=lambda: streaming_fwd(*k1_args), steps=TT,
            check=k1_route_check("resident", 8),
            faster_than=("rowgroup_ms", "streaming_ms"),
            net="G", U=U, P=P, B=rows, T=TT,
            rowgroup_ms=cuda_time_ms(rowgroup, 2),
            rowgroup_max_abs_err=rowgroup_errs, rowgroup_ok=rowgroup_ok,
            **k1_grid(rows, U, P, cdt, sms),
            **k1_bound(U, P, rows, TT, g_lens, dtype_name))
        r["ok"] = r["ok"] and rowgroup_ok
        results.append(r)

    # K3 at G's width, at the batches where every G layer's backward takes
    # it: B=32 (the CLI's default --batch_size), 64 and 256 (bench.py)
    for rows in K3_G_BATCHES:
        results.append(k3_g_width(rows, dtype_name, sms))

    # D: K1 at 16 and 32 rows, K2 at 16, K3 at 32 and 64 (the D step at
    # --batch_size 16 and 32)
    for rows in (B, 2 * B, 4 * B):
        rng = np.random.default_rng(7 + rows)
        d_lens = (TRAIN_LENGTHS * 4)[:rows]
        prm = layer_params(rng, DP, DU, DP, cdt, "cuda")
        x = torch.from_numpy(
            rng.normal(size=(TT, rows, DP)).astype(np.float32)).cuda()
        xw = (x.to(cdt).float() @ prm["w_x"].to(cdt).float()).to(cdt)
        lens_t = torch.tensor(d_lens, dtype=torch.int32, device="cuda")
        k1_args = (xw, lens_t, prm["w_h"], prm["proj"], prm["bias"],
                   prm["wi"], prm["wf"], prm["wo"])
        if rows <= 2 * B:
            results.append(timed(
                "lstm_fwd", dtype_name, lambda: ls.lstm_fwd(*k1_args),
                lambda: ls.lstm_fwd_reference(*k1_args), streams4,
                streaming=lambda: streaming_fwd(*k1_args), steps=TT,
                check=k1_route_check("rowgroup", 8),
                net="D", U=DU, P=DP, B=rows, T=TT,
                **k1_grid(rows, DU, DP, cdt, sms),
                **k1_bound(DU, DP, rows, TT, d_lens, dtype_name)))
        out, c_h, h_h, d_acts = ls.lstm_fwd(*k1_args)
        d_dout = torch.from_numpy(
            rng.normal(size=(TT, rows, DP)).astype(np.float32)).cuda()
        common = (d_acts, lens_t, d_dout, c_h)
        weights = (prm["w_h"], prm["proj"], prm["wi"], prm["wf"], prm["wo"])
        if rows < ls.ACC_BWD_MIN_BATCH:
            results.append(timed(
                "lstm_bwd", dtype_name, lambda: ls.lstm_bwd(*common, *weights),
                lambda: ls.lstm_bwd_reference(*common, *weights),
                ("dxw", "m", "dh"),
                streaming=lambda: streaming_bwd(*common, *weights),
                net="D", U=DU, P=DP, B=rows, T=TT,
                **resident_grid(ls.resident_plan(rows, DU, DP, cdt, sms)),
                **bwd_bound(DU, DP, rows, TT, d_lens, dtype_name, acc=False)))
        else:
            # the walk and the reduction apart, and the reduction by the
            # library beside it
            walk = lambda: ls._launch_bwd_rowgroup_walk(  # noqa: E731
                *common, *weights)
            dxw, m, dh, part = walk()
            reduction = lambda: ls._launch_wgrad(  # noqa: E731
                h_h, dxw, m, dh, part)
            apart = dict(
                walk_ms=cuda_time_ms(walk, 2),
                reduction_ms=cuda_time_ms(reduction, 5),
                **library_reduction(h_h, dxw, m, dh, reduction()[:2]),
                walk_bound_ms=bwd_bound(DU, DP, rows, TT, d_lens, dtype_name,
                                        acc=False)["bound_ms"],
                reduction_bound_ms=wgrad_bound(DU, DP, rows, TT, d_lens,
                                               dtype_name)["bound_ms"],
                reduction_splits=ls.wgrad_plan(TT, rows, DU, DP, sms).splits)
            before = ls.lstm_bwd_acc.launches_by_route.get("rowgroup", 0)
            results.append(timed(
                "lstm_bwd_acc", dtype_name,
                lambda: ls.lstm_bwd_acc(*common, h_h, *weights),
                lambda: ls.lstm_bwd_acc_reference(*common, h_h, *weights),
                K3_GRADS,
                streaming=lambda: ls._launch_bwd(*common, h_h, *weights,
                                                 acc=True),
                # the route: every call (1 + 5 timed + 2 relaunches) took
                # the row-group walk
                check=lambda: ls.lstm_bwd_acc.launches_by_route.get(
                    "rowgroup", 0) == before + 8,
                steps=TT, net="D", U=DU, P=DP, B=rows, T=TT, **apart,
                **rowgroup_grid(ls.rowgroup_bwd_plan(rows, DU, DP, cdt, sms)),
                **bwd_bound(DU, DP, rows, TT, d_lens, dtype_name, acc=True)))
    return results


def wgrad_bound(U_, P_, B_, T_, lengths, dtype_name):
    """K3's reduction: dW_h = Σ h(t-1)ᵀ·dxw(t) and dproj = Σ mᵀ·dh over
    the true row-steps; reads h_hist (f32) and the walk's dxw, m and dh
    there, writes dW_h and dproj."""
    G_, wb = 4 * U_, 2 if dtype_name == "bfloat16" else 4
    n = true_steps(lengths, T_)
    return bound(n * (2 * P_ * G_ + 2 * U_ * P_),
                 n * (P_ * 4 + (G_ + U_ + P_) * wb) + (P_ * G_ + U_ * P_) * 4,
                 dtype_name)


def library_reduction(h_hist, dxw, m, dh, kernel_grads) -> dict:
    """K3's reduction by the library on the walk's own streams: the two
    einsums of ``lstm_weight_grads`` (f32, as the port computes them for
    K2) timed, and their max |diff| against the kernel's dW_h and dproj
    (``kernel_grads``); and a bf16-operand ``torch.matmul`` of the same
    shapes timed."""
    import torch

    def einsums():
        dxf = dxw.float()
        return (torch.einsum("tbp,tbg->pg", h_hist[:-1], dxf[1:]),
                torch.einsum("tbu,tbp->up", m.float(), dh.float()))

    def rows(t):
        return t.reshape(-1, t.shape[-1]).to(torch.bfloat16)
    hb, gb, mb, db = rows(h_hist[:-1]), rows(dxw[1:]), rows(m), rows(dh)

    def bf16():
        return hb.t() @ gb, mb.t() @ db
    # each once first: cuBLAS loads a shape's kernels at their first call
    lib, _ = einsums(), bf16()
    return {"library_ms": cuda_time_ms(einsums, 5),
            "library_bf16_ms": cuda_time_ms(bf16, 5),
            "library_max_abs_diff": max(float((a - b).abs().max())
                                        for a, b in zip(lib, kernel_grads)),
            "library_of": "the reduction's dW_h and dproj: "
                          "lstm_weight_grads's two einsums in f32 "
                          "(library_bf16_ms: torch.matmul, bf16 operands)"}


def k3_g_width(rows: int, dtype_name: str, sms: int) -> dict:
    """K3 at G's width, B=rows, T=500, on one layer's forward streams
    (from the twin): all seven outputs against the twin, bit-equal
    relaunches, the route ``bwd_acc_route`` names checked by its count,
    csrc/lstm_bwd.cu timed beside it; on the resident route also the
    walk and the reduction timed apart; on the streaming route the
    resident one where its plan fits (f32 past RESIDENT_F32_MAX_ROWS)."""
    import torch
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    cdt = getattr(torch, dtype_name)
    rng = np.random.default_rng(10 + rows)
    lens = (TRAIN_LENGTHS * (rows // B))[:rows]
    prm = layer_params(rng, P, U, P, cdt, "cuda")
    x = torch.from_numpy(
        rng.normal(size=(TT, rows, P)).astype(np.float32)).cuda()
    xw = (x.to(cdt).float() @ prm["w_x"].to(cdt).float()).to(cdt)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    weights = (prm["w_h"], prm["proj"], prm["wi"], prm["wf"], prm["wo"])
    _, c_h, h_h, acts = ls.lstm_fwd_reference(
        xw, lens_t, prm["w_h"], prm["proj"], prm["bias"], prm["wi"],
        prm["wf"], prm["wo"])
    dout = torch.from_numpy(
        rng.normal(size=(TT, rows, P)).astype(np.float32)).cuda()
    args = (acts, lens_t, dout, c_h, h_h, *weights)
    route = ls.bwd_acc_route(rows, U, P, cdt, sms)
    extra = {"route": route, "net": "G", "U": U, "P": P, "B": rows, "T": TT}
    if route == "resident":
        walk = lambda: ls._launch_bwd_resident(  # noqa: E731
            acts, lens_t, dout, c_h, *weights, acc=True)
        dxw, m, dh = walk()[:3]
        reduction = lambda: ls._launch_wgrad(h_h, dxw, m, dh)  # noqa: E731
        extra.update(
            walk_ms=cuda_time_ms(walk, 2),
            reduction_ms=cuda_time_ms(reduction, 5),
            **library_reduction(h_h, dxw, m, dh, reduction()),
            walk_bound_ms=bwd_bound(U, P, rows, TT, lens, dtype_name,
                                    acc=False)["bound_ms"],
            reduction_bound_ms=wgrad_bound(U, P, rows, TT, lens,
                                           dtype_name)["bound_ms"],
            reduction_splits=ls.wgrad_plan(TT, rows, U, P, sms).splits,
            **resident_grid(ls.resident_plan(rows, U, P, cdt, sms,
                                             acc=True)))
    else:
        extra.update(design="streaming", grid=ls.lstm_bwd_grid(
            rows, U, P, True, cdt == torch.bfloat16))
        try:  # f32 past RESIDENT_F32_MAX_ROWS: the slower route, timed
            ls.resident_plan(rows, U, P, cdt, sms, acc=True)
            extra["resident_ms"] = cuda_time_ms(
                lambda: ls._launch_bwd_resident_acc(*args), 2)
        except ValueError:
            pass
    before = ls.lstm_bwd_acc.launches_by_route.get(route, 0)
    return timed(
        "lstm_bwd_acc", dtype_name, lambda: ls.lstm_bwd_acc(*args),
        lambda: ls.lstm_bwd_acc_reference(*args), K3_GRADS, reps=2,
        streaming=lambda: ls._launch_bwd(*args, acc=True), steps=TT,
        # the route: every call (1 + 2 timed + 2 relaunches) took it
        check=lambda: ls.lstm_bwd_acc.launches_by_route.get(
            route, 0) == before + 5,
        **extra, **bwd_bound(U, P, rows, TT, lens, dtype_name, acc=True))


def phase_kernels_train_small() -> dict:
    """The training kernels at odd sizes (K4 train mode at the SMALL
    shapes; K1, K2 and K3 at U=13, P=9 with 1, 3, 33 and 64 rows and at
    U=200, P=40: units that do not divide the grid; K1 also without its
    saved streams, on its resident route launched directly at those
    shapes, and at G's width, U=760, P=257, where lstm_fwd takes that
    route), f32, a zero-length row, absolute 1e-5
    scaled as above; the redesigned kernels (K4, K2, K1, K3) also checked
    for bit-equal relaunches. K3 takes any row count (here always its
    row-group walk)."""
    import torch
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    from rsrgan_tpu_torch.ops.wavefront import (lstm_wavefront_fwd_reference,
                                                lstm_wavefront_fwd_train)
    f32, tol, T_, lens = torch.float32, 1e-5, 17, [17, 11, 0]
    errs, ok = {}, True

    def check(tag, names, got, want):
        nonlocal ok
        e, _, good = compare_streams(names, got, want, "float32", tol)
        errs[tag] = max(e.values())
        ok = ok and good

    def deterministic(tag, fn):
        nonlocal ok
        errs[tag + "_same_bits"] = same_bits(fn)
        ok = ok and errs[tag + "_same_bits"]

    for L_, residual, U_, P_, B_ in SMALL:
        args = kernel_inputs(8, L_, U_, P_, B_, T_, (lens * 22)[:B_], f32,
                             "cuda")
        tag = f"wavefront_train_L{L_}_residual_{residual}_U{U_}_B{B_}"
        run = lambda: lstm_wavefront_fwd_train(*args,  # noqa: E731
                                               residual=residual)
        check(tag, ("taps", "c_hist", "h_hist", "acts"), run(),
              lstm_wavefront_fwd_reference(*args, residual=residual,
                                           save_acts=True))
        deterministic(tag, run)
    rng = np.random.default_rng(9)
    for rows, U_, P_ in ((1, 13, 9), (3, 13, 9), (33, 13, 9), (64, 13, 9),
                         (16, 200, 40)):
        row_lens = (lens * 22)[:rows]
        prm = layer_params(rng, P_, U_, P_, f32, "cuda")
        x = torch.from_numpy(
            rng.normal(size=(T_, rows, P_)).astype(np.float32)).cuda()
        lens_t = torch.tensor(row_lens, dtype=torch.int32, device="cuda")
        k1_args = (x @ prm["w_x"], lens_t, prm["w_h"], prm["proj"],
                   prm["bias"], prm["wi"], prm["wf"], prm["wo"])
        got = ls.lstm_fwd(*k1_args)
        tag = f"U{U_}_B{rows}"
        check(f"lstm_fwd_{tag}", ("out", "c_hist", "h_hist", "acts"), got,
              ls.lstm_fwd_reference(*k1_args))
        deterministic(f"lstm_fwd_{tag}", lambda: ls.lstm_fwd(*k1_args))
        check(f"lstm_fwd_no_acts_{tag}", ("out",),
              ls.lstm_fwd(*k1_args, save_acts=False)[:1],
              ls.lstm_fwd_reference(*k1_args, save_acts=False)[:1])
        # K1's resident route (K4's grid at L = 1, K = P padded) at the
        # same odd shapes, where fwd_route takes the row-group kernel
        for save in (True, False):
            n = 4 if save else 1
            check(f"lstm_fwd_resident_save_{save}_{tag}",
                  ("out", "c_hist", "h_hist", "acts")[:n],
                  ls._launch_fwd_resident(*k1_args, save_acts=save)[:n],
                  ls.lstm_fwd_reference(*k1_args, save_acts=save)[:n])
        deterministic(f"lstm_fwd_resident_{tag}",
                      lambda: ls._launch_fwd_resident(*k1_args,
                                                      save_acts=True))
        dout = torch.from_numpy(
            rng.normal(size=(T_, rows, P_)).astype(np.float32)).cuda()
        common = (got[3], lens_t, dout, got[1])
        weights = k1_args[2:4] + k1_args[5:]
        check(f"lstm_bwd_{tag}", ("dxw", "m", "dh"),
              ls.lstm_bwd(*common, *weights),
              ls.lstm_bwd_reference(*common, *weights))
        deterministic(f"lstm_bwd_{tag}",
                      lambda: ls.lstm_bwd(*common, *weights))
        check(f"lstm_bwd_acc_{tag}", K3_GRADS,
              ls.lstm_bwd_acc(*common, got[2], *weights),
              ls.lstm_bwd_acc_reference(*common, got[2], *weights))
        deterministic(f"lstm_bwd_acc_{tag}",
                      lambda: ls.lstm_bwd_acc(*common, got[2], *weights))
    # K1 at G's width on its resident route (K4's grid at L = 1), with
    # and without the saved streams
    prm = layer_params(rng, P, U, P, f32, "cuda")
    x = torch.from_numpy(rng.normal(size=(T_, B, P)).astype(np.float32))
    k1_args = (x.cuda() @ prm["w_x"],
               torch.tensor((lens * 6)[:B], dtype=torch.int32,
                            device="cuda"),
               prm["w_h"], prm["proj"], prm["bias"], prm["wi"], prm["wf"],
               prm["wo"])
    for save in (True, False):
        names = ("out", "c_hist", "h_hist", "acts") if save else ("out",)
        check(f"lstm_fwd_G_width_save_{save}", names,
              ls.lstm_fwd(*k1_args, save_acts=save),
              ls.lstm_fwd_reference(*k1_args, save_acts=save))
    deterministic("lstm_fwd_G_width", lambda: ls.lstm_fwd(*k1_args))
    torch.cuda.synchronize()
    out = {"phase": "kernels_train_small", "max_abs_err": errs, "tol": tol,
           "ok": ok}
    emit(out)
    return out


# The fused optimizer update (csrc/optim.cu) at the main path's leaf
# shapes: (net, optimizer, clip, the gradients' layout) as the three
# configurations train them. res_lstm_l's G with Adam and clip 15, also
# with its gradients as views into one flat buffer (all_reduce_mean's);
# LSTM-D with SGD and clip 15; SEGAN's G and D with RMSProp, no clip,
# each 3-D leaf's gradient strided as a convolution kernel's is.
SEGAN_DEPTHS = [16, 32, 32, 64, 64, 128, 128, 256, 256, 512, 1024]
OPTIM_CASES = (("G", "adam", 15.0, "own"), ("G", "adam", 15.0, "flat"),
               ("D", "sgd", 15.0, "own"), ("segan_G", "rmsprop", None, "conv"),
               ("segan_D", "rmsprop", None, "conv"))
OPTIM_UPDATES = 3     # checked against the plain path
OPTIM_TIMED = 20      # back-to-back updates a timing window
# bytes an element an update moves (f32): the clip's read of g, then g,
# p, the moments and the shadow read and p, the moments, the shadow
# written; a strided gradient's copy apart
OPTIM_BYTES = {("adam", True): 40, ("sgd", True): 24, ("rmsprop", False): 28}


def optim_leaf_shapes(net: str) -> list:
    import torch
    from rsrgan_tpu_torch.models import get_discriminator, get_generator
    from rsrgan_tpu_torch.models.segan import (SeganAEGenerator,
                                               SeganDiscriminator)
    make = {"G": lambda: get_generator("res_lstm_l", input_dim=P,
                                       output_dim=OUT),
            "D": lambda: get_discriminator("lstm", input_dim=OUT),
            "segan_G": lambda: SeganAEGenerator(
                (2 * SEGAN_CONTEXT + 1) * P, OUT, enc_depths=SEGAN_DEPTHS,
                bias_deconv=True),
            "segan_D": lambda: SeganDiscriminator(
                (2 * SEGAN_CONTEXT + 1) * P + OUT, num_fmaps=SEGAN_DEPTHS)}
    with torch.device("meta"):
        return [tuple(p.shape) for p in make[net]().parameters()]


def optim_grads(shapes, step, layout):
    """Seeded gradients at ``shapes``: the last leaf's zero, every third
    leaf's norm under the clip of 15 and the rest over it; ``layout``
    ``flat``: views into one buffer; ``conv``: a 3-D leaf's the reverse
    permutation of a contiguous tensor."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1000 + step)
    out = []
    for i, shape in enumerate(shapes):
        if layout == "conv" and len(shape) == 3:
            g = torch.randn(shape[::-1], generator=gen,
                            device="cuda").permute(2, 1, 0)
        else:
            g = torch.randn(shape, generator=gen, device="cuda")
        n = max(g.numel(), 1) ** 0.5
        g *= 0.0 if i == len(shapes) - 1 else 2.0 / n if i % 3 == 0 else 40 / n
        out.append(g)
    if layout == "flat":
        buf = torch.cat([g.reshape(-1) for g in out])
        at, views = 0, []
        for g in out:
            views.append(buf[at:at + g.numel()].view(g.shape))
            at += g.numel()
        out = views
    return out


def optim_case(net, name, max_norm, layout) -> dict:
    """One net's update on the fused path against the plain path
    (``NetState.apply_plain``, the twin) fed the same gradients clipped
    with the fused path's norms, OPTIM_UPDATES times from the same
    parameters: parameters, moments, Adam's count and shadow bit-equal,
    the norms within 1e-6 of the plain path's own; after the first update
    no ``host_wait``, one ``opt.fused``, and the launches
    ``FusedUpdate`` counts (2 an update; 1 for RMSProp without the clip);
    then both timed on the card over OPTIM_TIMED updates, and the fused
    update's host ms to issue them."""
    import torch
    from rsrgan_tpu_torch import spans
    from rsrgan_tpu_torch.ops import optim
    from rsrgan_tpu_torch.training.state import NetState
    shapes = optim_leaf_shapes(net)

    def state(clip):
        gen = torch.Generator(device="cuda").manual_seed(0)
        m = torch.nn.Module()
        for i, shape in enumerate(shapes):
            m.register_parameter(f"w{i}", torch.nn.Parameter(torch.randn(
                shape, generator=gen, device="cuda") * 0.05))
        return NetState(m, name, clip)

    fused, plain = state(max_norm), state(None)
    keys = list(fused.params())
    per_update = 2 if (max_norm is not None or name == "adam") else 1
    errs, norm_errs, counted, host_waits = [], [], [], []
    for step in range(OPTIM_UPDATES):
        grads = dict(zip(keys, optim_grads(shapes, step, layout)))
        before = optim.FusedUpdate.launches
        spans.clear()
        spans.enable()
        fused.apply_gradients(grads, 1e-3, 0.9999)
        spans.disable()
        r = spans.read()
        counted.append((optim.FusedUpdate.launches - before,
                        r.total("opt.fused"), r.total("opt.plain")))
        host_waits.append(r.total("host_wait"))
        norms = fused._fused_update.norms.clone()
        if max_norm is not None:
            want = torch.stack([torch.sqrt(torch.sum(torch.square(g)))
                                for g in grads.values()])
            norm_errs.append(float(((norms - want).abs()
                                    / want.clamp(min=1e-30)).max()))
            grads = {k: g * (max_norm / torch.clamp(n, min=max_norm))
                     for (k, g), n in zip(grads.items(), norms)}
        plain.apply_plain(plain.params(), grads, 1e-3, 0.9999)
        torch.cuda.synchronize()
        pairs = [(fused.params()[k], plain.params()[k]) for k in keys]
        pairs += [(fused.ema[k], plain.ema[k]) for k in keys]
        pairs += [(fused.opt_state[f][k], plain.opt_state[f][k])
                  for f in ("mu", "nu") if f in plain.opt_state for k in keys]
        errs.append(max(float((a - b).detach().abs().max())
                        for a, b in pairs))
    count_ok = (name != "adam"
                or int(fused.opt_state["count"])
                == int(plain.opt_state["count"]) == OPTIM_UPDATES)
    grads = dict(zip(keys, optim_grads(shapes, OPTIM_UPDATES, layout)))
    ms, host_ms = device_and_host_ms(
        lambda: fused.apply_gradients(grads, 1e-3, 0.9999), OPTIM_TIMED)
    plain_ms, plain_host_ms = device_and_host_ms(
        lambda: plain.apply_plain(plain.params(), grads, 1e-3, 0.9999), 5)
    elements = sum(int(np.prod(s)) for s in shapes)
    nbytes = OPTIM_BYTES[(name, max_norm is not None)] * elements
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"phase": "kernels_train", "kernel": "optim_update", "net": net,
           "optimizer": name, "clip": max_norm, "layout": layout,
           "leaves": len(shapes), "elements": elements,
           "bit_equal": max(errs) == 0.0, "max_abs_err": max(errs),
           "norm_max_rel_err": max(norm_errs, default=None),
           "launches_per_update": [c[0] for c in counted],
           "host_waits": host_waits, "ms": ms, "host_ms": host_ms,
           "plain_ms": plain_ms, "plain_host_ms": plain_host_ms,
           "bound_ms": bound_ms, "bound_by": "bytes",
           "bound_bytes": nbytes,
           "ok": (max(errs) == 0.0 and count_ok
                  and all(e <= 1e-6 for e in norm_errs)
                  and all(c == (per_update, 1, 0) for c in counted[1:])
                  and not any(host_waits[1:]))}
    emit(out)
    return out


def device_and_host_ms(fn, reps: int) -> tuple:
    """ms a call of ``fn`` over ``reps`` back-to-back calls: on the card
    (CUDA events around them) and on the host to issue them."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def phase_kernels_train_optim() -> list:
    """The fused optimizer update at every OPTIM_CASES net's leaf
    shapes against its plain twin (``optim_case``)."""
    return [optim_case(*case) for case in OPTIM_CASES]


def rel_errs(got: dict, want: dict) -> dict:
    return {k: float((got[k] - want[k]).detach().abs().max())
            / max(float(want[k].detach().abs().max()), 1e-30) for k in want}


def phase_grad() -> dict:
    """f32 gradients at full width: the G stack at B=16 (wavefront train
    forward + K2 per layer) and B=32 (+ K3 per layer, on its resident
    route) and D at 16 rows (K1 + K2) and 32 rows (K1 + K3), each against
    the eager cell under autograd."""
    import torch
    from rsrgan_tpu_torch.models import get_discriminator
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    from rsrgan_tpu_torch.ops.lstm import lstm_cell_forward
    from rsrgan_tpu_torch.ops.wavefront_stack import lstm_stack_wavefront
    rng = np.random.default_rng(11)
    tree = generator_tree(12)

    def g_inputs(rng, rows):
        lens = torch.tensor((TRAIN_LENGTHS * (rows // B))[:rows],
                            dtype=torch.int32, device="cuda")
        x = rng.normal(size=(rows, TT, P)).astype(np.float32)
        w = torch.from_numpy(
            rng.normal(size=(rows, TT, P)).astype(np.float32)).cuda()
        return x, w, lens

    def g_grads(kernel: bool, x, w, lens) -> dict:
        params = [{k: torch.from_numpy(v).cuda().requires_grad_(True)
                   for k, v in tree[f"lstm_cell_{i + 1}"].items()}
                  for i in range(L)]
        xt = torch.from_numpy(x).cuda().requires_grad_(True)
        if kernel:
            tap = lstm_stack_wavefront(xt, lens, params, True,
                                       compute_dtype=torch.float32,
                                       save_acts=True)
        else:
            tap = xt
            for p in params:
                tap = lstm_cell_forward(tap, lens, p) + tap
        (tap * w).sum().backward()
        out = {"x": xt.grad}
        out.update({f"lstm_cell_{i + 1}/{k}": v.grad
                    for i, p in enumerate(params) for k, v in p.items()})
        return out

    g16 = g_inputs(rng, B)
    g_err = rel_errs(g_grads(True, *g16), g_grads(False, *g16))
    # B=32: every layer's backward takes K3's resident route (a count each)
    g32 = g_inputs(np.random.default_rng(14), 2 * B)
    before = ls.lstm_bwd_acc.launches_by_route.get("resident", 0)
    g32_kernel = g_grads(True, *g32)
    g32_launches = (ls.lstm_bwd_acc.launches_by_route.get("resident", 0)
                    - before)
    g32_err = rel_errs(g32_kernel, g_grads(False, *g32))
    d_err = {}
    for rows in (B, 2 * B):
        torch.manual_seed(rows)
        nets = {impl: get_discriminator("lstm", compute_dtype=torch.float32,
                                        lstm_impl=impl).cuda()
                for impl in ("wavefront", "scan")}
        nets["scan"].load_state_dict(nets["wavefront"].state_dict())
        d_x = rng.normal(size=(rows, TT, DP)).astype(np.float32)
        d_w = torch.from_numpy(
            rng.normal(size=(rows, TT, 1)).astype(np.float32)).cuda()
        d_lens = torch.tensor((TRAIN_LENGTHS * 2)[:rows], dtype=torch.int32,
                              device="cuda")
        grads = {}
        for impl, net in nets.items():
            xt = torch.from_numpy(d_x).cuda().requires_grad_(True)
            (net(xt, d_lens, train=True) * d_w).sum().backward()
            grads[impl] = {"x": xt.grad, **{n: p.grad for n, p in
                                            net.named_parameters()}}
        d_err[rows] = rel_errs(grads["wavefront"], grads["scan"])
    worst = max([*g_err.values(), *g32_err.values()]
                + [e for d in d_err.values() for e in d.values()])
    out = {"phase": "grad", "dtype": "float32", "G_rel_err_max":
           max(g_err.values()), "G32_rel_err_max": max(g32_err.values()),
           "G32_k3_resident_launches": g32_launches,
           "D16_rel_err_max": max(d_err[B].values()),
           "D32_rel_err_max": max(d_err[2 * B].values()),
           "G_rel_err": g_err, "G32_rel_err": g32_err, "tol": GRAD_TOL,
           "ok": worst <= GRAD_TOL and g32_launches == L}
    emit(out)
    return out


# The prepare phase's corpus: 128 train utterances (257 -> 40) in four
# length buckets of 32, so that an epoch at B=16 has two batches per
# bucket, which the shuffle interleaves (the JAX CLI's update order then
# differs from the batcher's); 16 cv utterances in one bucket. Features
# on an LPS-like scale, so that the CMVN the phase computes does work.
CORPUS = (("train", (150, 300, 400, 550), 32), ("cv", (350,), 16))


def prepare_cli(*argv) -> tuple:
    """``python -m rsrgan_tpu_torch.cli.prepare ...`` as a process: (exit
    code, wall seconds, its output)."""
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "rsrgan_tpu_torch.cli.prepare", *argv],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=300)
    return (proc.returncode, time.monotonic() - t0,
            (proc.stdout + proc.stderr).strip())


def phase_prepare(work: str) -> dict:
    """Kaldi arks (every other matrix compressed, formats 1 and 2 by row
    count) and CMVN stats written through the port, then the data
    preparation CLI as a user runs it: cmvn, make-store (train and cv),
    split and verify-store, each a process that must exit 0; every
    stored matrix must be bit-equal to the port's own read of its ark
    with the CMVN applied. The train phase trains from these stores."""
    from rsrgan_tpu_torch.data import (ArkWriter, CmvnAccumulator, ScpReader,
                                       UtteranceStore, load_cmvn_npz,
                                       write_kaldi_cmvn)
    rng = np.random.default_rng(13)
    data_dir = os.path.join(work, "train_data")
    stores = os.path.join(data_dir, "stores")
    frames = {}
    for name, buckets, per in CORPUS:
        d = os.path.join(data_dir, name)
        os.makedirs(d)
        k = 0
        with ArkWriter(os.path.join(d, "inputs.scp")) as win, \
                ArkWriter(os.path.join(d, "labels.scp")) as wlab:
            for b, lo in enumerate(buckets):
                for i in range(per):
                    n = int(rng.integers(lo, lo + 50))
                    utt = f"{name}{b}_{i:02d}"
                    compress = k % 2 == 0
                    win.write_next_utt(
                        os.path.join(d, "inputs.ark"), utt,
                        rng.normal(2.0, 3.0, size=(n, P)).astype(np.float32),
                        compress=compress)
                    wlab.write_next_utt(
                        os.path.join(d, "labels.ark"), utt,
                        rng.normal(0.5, 1.5, size=(n, OUT)).astype(
                            np.float32), compress=compress)
                    k += 1
    # Kaldi's compute-cmvn-stats over the train features as they read back
    acc = {"inputs": CmvnAccumulator(P), "labels": CmvnAccumulator(OUT)}
    train = os.path.join(data_dir, "train")
    for kind, a in acc.items():
        for _, mat in ScpReader(os.path.join(train, f"{kind}.scp")):
            a.accumulate(mat)
        write_kaldi_cmvn(os.path.join(train, f"{kind}.cmvn"),
                         a.stats_matrix())
    runs = {"cmvn": prepare_cli(
        "cmvn", f"--inputs={train}/inputs.cmvn",
        f"--labels={train}/labels.cmvn", f"--save_dir={data_dir}")}
    lists = {}
    for name, _, _ in CORPUS:
        d = os.path.join(data_dir, name)
        runs[f"make-store {name}"] = prepare_cli(
            "make-store", f"--inputs={d}/inputs.scp",
            f"--labels={d}/labels.scp", f"--cmvn_dir={data_dir}",
            f"--output_dir={stores}", f"--name={name}")
        lists[name] = os.path.join(data_dir, f"{name}.list")
        with open(lists[name], "w") as f:
            f.write(os.path.join(stores, f"{name}.rtu") + "\n")
    # split: the whole corpus's scp pair into tr/ (128) and cv/ (16)
    whole = os.path.join(data_dir, "whole")
    os.makedirs(whole)
    for kind in ("inputs", "labels"):
        with open(os.path.join(whole, f"{kind}.scp"), "w") as f:
            for name, _, _ in CORPUS:
                with open(os.path.join(data_dir, name, f"{kind}.scp")) as g:
                    f.write(g.read())
    runs["split"] = prepare_cli("split", "--val_size=16",
                                f"--data_dir={whole}", "--seed=123")
    split_lines = {}
    for sub in ("tr", "cv"):
        with open(os.path.join(whole, sub, "inputs.scp")) as f:
            split_lines[sub] = f.read().splitlines()
    with open(os.path.join(whole, "inputs.scp")) as f:
        all_lines = f.read().splitlines()
    split_ok = (len(split_lines["cv"]) == 16
                and sorted(split_lines["tr"] + split_lines["cv"])
                == sorted(all_lines))
    runs["verify-store"] = prepare_cli(
        "verify-store", *(os.path.join(stores, f"{n}.rtu") for n, _, _ in
                          CORPUS))
    # every stored matrix against the port's read of its ark, CMVN applied
    # in float64 as make-store applies it
    cmvn_in, cmvn_lab = load_cmvn_npz(os.path.join(data_dir,
                                                   "train_cmvn.npz"))
    stored_equal = True
    for name, _, _ in CORPUS:
        store = UtteranceStore(os.path.join(stores, f"{name}.rtu"))
        d = os.path.join(data_dir, name)
        reads = (ScpReader(os.path.join(d, "inputs.scp")),
                 ScpReader(os.path.join(d, "labels.scp")))
        stored_equal = stored_equal and store.utt_ids == reads[0].utt_ids
        for i, utt in enumerate(store.utt_ids):
            for got, reader, cmvn in ((store.inputs(i), reads[0], cmvn_in),
                                      (store.labels(i), reads[1], cmvn_lab)):
                want = cmvn.apply(np.asarray(reader.read_utt(utt),
                                             np.float64)).astype(np.float32)
                stored_equal = stored_equal and np.array_equal(got, want)
        frames[name] = int(store.lengths.sum())
    out = {"phase": "prepare", "utterances": {n: p * len(b) for n, b, p in
                                              CORPUS},
           "frames": frames, "compressed_share": 0.5,
           "cli": {k: {"rc": rc, "seconds": secs, "output": text[-200:]}
                   for k, (rc, secs, text) in runs.items()},
           "make_store_train_frames_per_s_process":
               frames["train"] / runs["make-store train"][1],
           # cmvn reads two small stats files: its wall time is about
           # the interpreter's start-up, which every subcommand pays
           "startup_seconds_cmvn": runs["cmvn"][1],
           "make_store_train_frames_per_s_less_startup":
               frames["train"] / (runs["make-store train"][1]
                                  - runs["cmvn"][1]),
           "split_ok": split_ok, "stored_bit_equal": stored_equal,
           "name, power.limit": card_name_and_limit(),
           "ok": (all(rc == 0 for rc, _, _ in runs.values()) and split_ok
                  and stored_equal
                  and runs["verify-store"][2].count(", OK") == 2)}
    out["lists"] = {"train": lists["train"], "cv": lists["cv"],
                    "data_dir": data_dir}
    emit(out)
    return out


def train_step_parity(tr_list: str) -> dict:
    """One f32 train step (1 D + 2 G) on one B=16 batch of the train
    store, through the kernels and through --lstm_impl=scan, from the same
    seeded state, noise std 0. Gated: the gradients of all three steps
    and the post-step D params (SGD: the update is linear in the
    gradient); reported only: the post-step G params, which pass through
    Adam's first step (update = g / (|g| + eps), so a gradient element
    near 0 may take either sign on either side)."""
    import torch
    from rsrgan_tpu_torch.data import (SequenceBatcher, UtteranceStore,
                                       read_list_file)
    from rsrgan_tpu_torch.models import get_discriminator, get_generator
    from rsrgan_tpu_torch.training import GanTrainer, default_hparams
    store = UtteranceStore(read_list_file(tr_list))
    batch = next(iter(SequenceBatcher(store, B, seed=1)))
    inputs, labels, lens = (torch.from_numpy(a).cuda() for a in
                            (batch.inputs, batch.labels, batch.lengths))
    hp = dict(default_hparams(), disc_noise_std=0.0)
    logs, states = {}, {}
    for impl in ("wavefront", "scan"):
        gen = torch.Generator().manual_seed(21)
        g = get_generator("res_lstm_l", input_dim=P, output_dim=OUT,
                          compute_dtype=torch.float32, lstm_impl=impl,
                          generator=gen).cuda()
        d = get_discriminator("lstm", compute_dtype=torch.float32,
                              lstm_impl=impl, generator=gen).cuda()
        trainer = GanTrainer(g, d, output_dim=OUT, input_dim=P,
                             l2_scale=1e-5)
        state = trainer.init_state()
        trainer.grad_log = []
        trainer.train_step(state, inputs, labels, lens, hp)
        logs[impl], states[impl] = trainer.grad_log, state
    names = ("d_step", "g_step_1", "g_step_2")
    errs = {n: max(rel_errs(k[1], s[1]).values())
            for n, k, s in zip(names, logs["wavefront"], logs["scan"])}
    post = {net: max(rel_errs(
        dict(getattr(states["wavefront"], net).module.named_parameters()),
        dict(getattr(states["scan"], net).module.named_parameters()))
        .values()) for net in ("g", "d")}
    return {"grad_rel_err": errs, "post_step_param_rel_err": post,
            "tol": GRAD_TOL,
            "ok": (all(e <= GRAD_TOL for e in errs.values())
                   and len(errs) == 3 and post["d"] <= GRAD_TOL)}


def longest_utterances(store, rows: int) -> tuple:
    """(inputs, labels, lengths) of the store's ``rows`` longest
    utterances, padded as a SequenceBatcher pads their length bucket."""
    from rsrgan_tpu_torch.data.dataset import bucket_id, padded_length
    idx = np.argsort(-np.asarray(store.lengths), kind="stable")[:rows]
    lengths = np.asarray([store.lengths[i] for i in idx], dtype=np.int32)
    t_pad = padded_length(bucket_id(int(lengths.max())), int(lengths.max()))
    inputs = np.zeros((rows, t_pad, store.input_dim), np.float32)
    labels = np.zeros((rows, t_pad, store.output_dim), np.float32)
    for row, i in enumerate(idx):
        inputs[row, :lengths[row]] = store.inputs(i)
        labels[row, :lengths[row]] = store.labels(i)
    return inputs, labels, lengths


def parse_shape(key: str) -> dict:
    """``shape_key``'s string back to its sizes."""
    return {k: int(v) for k, v in
            (item.split("=") for item in key.split(","))}


def launches_at_units(by_shape: dict, units: int) -> int:
    """The launches of a count by shape at the layer width U=units."""
    return sum(n for key, n in by_shape.items()
               if parse_shape(key)["U"] == units)


def reset_counts(counters: dict) -> None:
    """Every launch count of ``counters`` (name -> (wrapper, attribute[,
    key])) set to 0, or emptied where it is a count by shape or route."""
    for fn, attr, *_ in counters.values():
        setattr(fn, attr, type(getattr(fn, attr))())


def read_counts(counters: dict) -> dict:
    """Each count of ``counters``: a number, a copy of a count by shape,
    or one route's entry (``key``) of a count by route."""
    out = {}
    for name, (fn, attr, *key) in counters.items():
        v = getattr(fn, attr)
        out[name] = (v.get(key[0], 0) if key
                     else dict(v) if isinstance(v, dict) else v)
    return out


def profile_train_step(tr_list: str, rows: int, counters: dict) -> dict:
    """Device time by kernel of one bf16 train step on the kernels (a
    warm-up step first), from torch.profiler; wall time from the host
    clock around the step and a synchronize; the launches of the profiled
    step (``counters``, as phase_train's, set to 0 just before it). B=16:
    the T=600 bucket's batch; B=32 (the CLI's default): the 32 longest
    utterances, padded to the longest's bucket."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rsrgan_tpu_torch.data import (SequenceBatcher, UtteranceStore,
                                       read_list_file)
    from rsrgan_tpu_torch.models import get_discriminator, get_generator
    from rsrgan_tpu_torch.training import GanTrainer
    store = UtteranceStore(read_list_file(tr_list))
    if rows == B:
        batch = max(SequenceBatcher(store, B, seed=1),
                    key=lambda b: b.inputs.shape[1])   # the T=600 bucket
        arrays = (batch.inputs, batch.labels, batch.lengths)
    else:
        arrays = longest_utterances(store, rows)
    args = tuple(torch.from_numpy(a).cuda() for a in arrays)
    gen = torch.Generator().manual_seed(31)
    trainer = GanTrainer(
        get_generator("res_lstm_l", input_dim=P, output_dim=OUT,
                      compute_dtype=torch.bfloat16, generator=gen).cuda(),
        get_discriminator("lstm", compute_dtype=torch.bfloat16,
                          lstm_impl="wavefront", generator=gen).cuda(),
        output_dim=OUT, input_dim=P, l2_scale=1e-5)
    state = trainer.init_state()
    hp = {"g_lr": 3e-4, "d_lr": 1e-3, "mse_lambda": 1.0,
          "disc_noise_std": 0.05, "d_real": 1.0, "d_fake": 0.0}
    noise = torch.Generator(device="cuda").manual_seed(32)
    trainer.train_step(state, *args, hp, noise)
    torch.cuda.synchronize()
    reset_counts(counters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        m = trainer.train_step(state, *args, hp, noise)
        float(m["g_loss"])
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    launches = read_counts(counters)
    # kernel rows only: an op row (an autograd node, aten::mm) also
    # carries the device time of the kernels launched inside it
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            key = e.key[:100]
            by_kernel[key] = by_kernel.get(key, 0.0) + us / 1e3
    device_ms = sum(by_kernel.values())
    # lstm_bwd_resident_kernel<W, acc>: K2 (acc=false), and K3's walk in
    # acc mode; the profiled steps run bf16; the fused optimizer's two
    ours = {name: sum(v for k, v in by_kernel.items() if name in k)
            for name in ("wavefront_resident_kernel",
                         K2_BF16_KERNEL, K3_WALK_BF16_KERNEL,
                         "lstm_fwd_rowgroup_kernel",
                         "lstm_bwd_rowgroup_kernel", "lstm_wgrad_kernel",
                         "lstm_bwd_kernel", "sumsq_kernel", "update_kernel")}
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])
    return {"T": int(args[0].shape[1]), "B": rows,
            "true_frames": int(args[2].sum()), "launches": launches,
            "wall_ms": wall_ms,
            "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "hand_kernels_ms": ours,
            "other_kernels_ms": device_ms - sum(ours.values()),
            "top_kernels_ms": top}


def step_peak_bytes(tr_list: str, rows: int) -> int:
    """Device bytes one bf16 train step at ``rows`` (the store's longest
    utterances, T=600) allocates at its peak, the model and its optimizer
    state included: what the device feed's budget must leave free."""
    import gc

    import torch
    from rsrgan_tpu_torch.data import UtteranceStore, read_list_file
    from rsrgan_tpu_torch.models import get_discriminator, get_generator
    from rsrgan_tpu_torch.training import GanTrainer, default_hparams
    store = UtteranceStore(read_list_file(tr_list))
    arrays = longest_utterances(store, rows)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator().manual_seed(41)
    trainer = GanTrainer(
        get_generator("res_lstm_l", input_dim=P, output_dim=OUT,
                      compute_dtype=torch.bfloat16, generator=gen).cuda(),
        get_discriminator("lstm", input_dim=OUT,
                          compute_dtype=torch.bfloat16,
                          lstm_impl="wavefront", generator=gen).cuda(),
        output_dim=OUT, input_dim=P, l2_scale=1e-5)
    state = trainer.init_state()
    trainer.train_step(state, *(torch.from_numpy(a).cuda() for a in arrays),
                       default_hparams())
    torch.cuda.synchronize()
    return int(torch.cuda.max_memory_allocated() - base)


def with_optim_counts(fn) -> tuple:
    """``fn()`` with the fused optimizer's launch counts
    (``FusedUpdate``: all, and by ``"<kind> leaves=<n>"``) set to 0 and
    the spans armed; (its result, the counts with the updates on the
    fused and the plain path). Every update of a training run on the
    card must be fused: one on the plain path raises."""
    import torch
    from rsrgan_tpu_torch import spans
    from rsrgan_tpu_torch.ops import optim
    counts = {"launches": (optim.FusedUpdate, "launches"),
              "by_shape": (optim.FusedUpdate, "launches_by_shape")}
    reset_counts(counts)
    spans.clear()
    spans.enable()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        spans.disable()
    r = spans.read()
    spans.clear()
    counts = {**read_counts(counts), "fused_updates": r.total("opt.fused"),
              "plain_updates": r.total("opt.plain")}
    if counts["plain_updates"]:
        raise RuntimeError(f"an update took the plain optimizer path on "
                           f"the card: {counts}")
    return out, counts


def cli_epoch(train_cli, counters, flags) -> tuple:
    """One CLI training epoch with every launch count set to 0 just
    before it; (its last train and eval metrics rows, the counts, wall
    seconds). The counts hold ``optim``, the fused optimizer's
    (``with_optim_counts``)."""
    reset_counts(counters)
    t0 = time.monotonic()
    rc, optim_counts = with_optim_counts(lambda: train_cli.main(flags))
    secs = time.monotonic() - t0
    launches = read_counts(counters)
    launches["optim"] = optim_counts
    if rc != 0:
        raise RuntimeError(f"training {flags[-3:]} returned {rc}")
    save_dir = next(f.split("=", 1)[1] for f in flags
                    if f.startswith("--save_dir="))
    rows = []
    for split in ("train", "eval"):
        with open(os.path.join(save_dir, f"metrics_{split}.jsonl")) as f:
            rows.append(json.loads(f.readlines()[-1]))
    return rows[0], rows[1], launches, secs


def on_kernel_routes(launches: dict) -> bool:
    """The flagship step's routes at B=16: K4 train mode, K1, K2 and K3's
    row-group walk, none of it on csrc/lstm_bwd.cu."""
    return (all(launches[k] > 0 for k in ("wavefront_fwd_train", "lstm_fwd",
                                           "lstm_bwd", "lstm_bwd_acc"))
            and launches["lstm_bwd_acc_streaming"] == 0)


def speed(row) -> dict:
    """Train frames/s and ms per iteration of a CLI epoch's last row."""
    return {"train_frames_per_s": row["train_frames_per_sec"],
            "ms_per_iteration": 1e3 * row["train_secs"] / row["train_steps"],
            "steps": row["train_steps"]}


def finite_losses(row, cv_row) -> bool:
    return all(np.isfinite(v) for r in (row, cv_row) for k, v in r.items()
               if k.endswith("loss"))


# ms per iteration of the dropout epoch below with K1 at G width on the
# row-group kernel, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md)
DROPOUT_MS_ROWGROUP = (504.3, 526.9)


def k1_routes_ok(launches: dict, resident: int, rowgroup: int) -> bool:
    """K1's launches of a run (``lstm_fwd_by_route``): ``resident`` on
    K4's grid at L = 1 (G width) and ``rowgroup`` on the row-group kernel
    (the D layer), none elsewhere."""
    by_route = launches["lstm_fwd_by_route"]
    return (by_route.get("resident", 0) == resident
            and by_route.get("rowgroup", 0) == rowgroup
            and launches["lstm_fwd"] == resident + rowgroup)


def g_width_checks(runs) -> list:
    """K1 and K2 at every G-width shape (U=760) the runs (launch counts by
    shape) launched them at, against their twins in f32 and bf16 at
    T=CHAIN_T, ragged rows (``chain_kernel``; K1 on the route
    ``fwd_route`` names, checked by its count)."""
    shapes = sorted({(name, key) for launches in runs
                     for name in ("lstm_fwd", "lstm_bwd")
                     for key in launches[f"{name}_by_shape"]
                     if parse_shape(key)["U"] == U})
    return [chain_kernel(name, key, d, phase="train_g_width_kernels")
            for name, key in shapes for d in ("float32", "bfloat16")]


def dropout_epoch(train_cli, counters, flags, main_row, main_launches):
    """--keep_prob=0.8 with res_lstm_l, on the same batches as the main
    path: G leaves the wavefront for the per-layer kernels, K1 at G width
    forward (4 layers x 3 G forwards an iteration: the D step's fake and
    each G step draw their own masks) on its resident route and K2
    backward at B=16, no K4 in train mode. K1 at G width is counted where
    the wrapper launches it (``lstm_fwd.launches_by_shape`` at U=760,
    ``launches_by_route``); D's and the cv pass's K1 launches are the
    main path's, on the row-group kernel."""
    row, cv_row, launches, secs = cli_epoch(
        train_cli, counters, flags("dropout", "--keep_prob=0.8"))
    steps = row["train_steps"]
    k1_g = launches_at_units(launches["lstm_fwd_by_shape"], U)
    out = {"launches": launches, "k1_g_width_launches": k1_g,
           "k1_g_width_per_iteration": k1_g / steps, "seconds": secs,
           "speed": speed(row), "flagship_speed": speed(main_row),
           "ms_per_iteration_rowgroup_k1": DROPOUT_MS_ROWGROUP,
           "losses": {k: v for k, v in row.items() if k.endswith("loss")}}
    out["ok"] = (finite_losses(row, cv_row)
                 and steps == main_row["train_steps"]
                 and k1_g == L * 3 * steps
                 and k1_routes_ok(launches, k1_g, main_launches["lstm_fwd"])
                 and launches["wavefront_fwd_train"] == 0
                 and launches["lstm_bwd"] == main_launches["lstm_bwd"]
                 and launches["lstm_bwd_acc_streaming"] == 0)
    emit({"phase": "train_dropout", **out,
          "name, power.limit": card_name_and_limit()})
    return out


def res_lstm_i_epoch(train_cli, flags, work, data_dir, cv_list, main_row,
                     main_launches):
    """--g_type=res_lstm_i (2 layers; the second takes the first's output
    plus the inputs, which the wavefront cannot express): G always per
    layer, in training and in decode. One epoch on the main path's
    batches: K1 at G width on its resident route for 2 layers of every G
    forward (the main path's K4 train and decode launches: the shared
    forward and the second G step's, and one a cv batch), K2 backward for
    2 layers in each of the 2 G steps where res_lstm_l has 4, no K4; D's
    K1, K2 and K3 launches as the main path's. Then --decode from its
    checkpoint: K1 at G width without its saved streams, 2 a decode
    batch, on the resident route, no K4."""
    import torch
    counters = chain_counters()
    row, cv_row, launches, secs = cli_epoch(
        train_cli, counters, flags("res_lstm_i", "--g_type=res_lstm_i"))
    steps = row["train_steps"]
    k1_g = launches_at_units(launches["lstm_fwd_by_shape"], U)
    g_forwards = (main_launches["wavefront_fwd_train"]
                  + main_launches["wavefront_fwd"])
    save_dir = os.path.join(work, "res_lstm_i")
    reset_counts(counters)
    decode = decode_checkpoint(
        train_cli, ["--trainer=gan_rnn", "--g_type=res_lstm_i",
                    "--decode_batch_size=16", f"--input_dim={P}",
                    f"--output_dim={OUT}", f"--data_dir={data_dir}",
                    f"--test_list_file={cv_list}", f"--save_dir={save_dir}"],
        save_dir, 16)
    torch.cuda.synchronize()
    dec = read_counts(counters)
    dec_k1 = dec["lstm_fwd"]
    checks = g_width_checks((launches, dec))
    out = {"launches": launches, "k1_g_width_launches": k1_g,
           "k1_g_width_per_iteration": k1_g / steps, "seconds": secs,
           "speed": speed(row), "flagship_speed": speed(main_row),
           "losses": {k: v for k, v in row.items() if k.endswith("loss")},
           "decode": {**decode, "launches": dec},
           "g_width_kernels_ok": all(r["ok"] for r in checks)}
    out["ok"] = (finite_losses(row, cv_row)
                 and steps == main_row["train_steps"]
                 and k1_g == 2 * g_forwards
                 and k1_routes_ok(launches, k1_g, main_launches["lstm_fwd"])
                 and launches["wavefront_fwd_train"] == 0
                 and launches["wavefront_fwd"] == 0
                 and launches["lstm_bwd"]
                 == main_launches["lstm_bwd"] - (L - 2) * 2 * steps
                 and launches["lstm_bwd_acc"] == main_launches["lstm_bwd_acc"]
                 and launches["lstm_bwd_acc_resident"] == 0
                 and launches["lstm_bwd_acc_streaming"] == 0
                 and decode["ok"] and dec_k1 > 0 and dec_k1 % 2 == 0
                 and k1_routes_ok(dec, dec_k1, 0)
                 and dec["wavefront_fwd"] == 0
                 and out["g_width_kernels_ok"])
    emit({"phase": "train_res_lstm_i", **out,
          "name, power.limit": card_name_and_limit()})
    return out


def lstm_epoch(train_cli, counters, flags, work, data_dir, cv_list,
               main_row, main_launches):
    """--g_type=lstm: K4 in train mode at L=3, U=760, P=280, residual
    off (two launches an iteration: the G forward the D step shares with
    the first G step, and the second G step's), K2 backward for its 3
    layers in each of the 2 G steps where res_lstm_l has 4, D's K1, K2
    and K3 launches as the main path's; then --decode from its
    checkpoint on K4's decode mode (launches counted apart)."""
    import torch
    row, cv_row, launches, secs = cli_epoch(
        train_cli, counters, flags("lstm", "--g_type=lstm"))
    steps = row["train_steps"]
    k2_want = main_launches["lstm_bwd"] - (L - 3) * 2 * steps
    reset_counts(counters)
    save_dir = os.path.join(work, "lstm")
    rc = train_cli.main(["--decode", "--trainer=gan_rnn", "--g_type=lstm",
                         "--decode_batch_size=16", f"--input_dim={P}",
                         f"--output_dim={OUT}", f"--data_dir={data_dir}",
                         f"--test_list_file={cv_list}",
                         f"--save_dir={save_dir}"])
    torch.cuda.synchronize()
    decode_launches = counters["wavefront_fwd"][0].launches
    ark = read_ark(os.path.join(save_dir, "test", "feats.scp"))
    out = {"launches": launches, "decode_launches": decode_launches,
           "lstm_bwd_expected": k2_want, "seconds": secs,
           "speed": speed(row), "decoded": len(ark)}
    out["ok"] = (finite_losses(row, cv_row)
                 and steps == main_row["train_steps"]
                 and launches["wavefront_fwd_train"] == 2 * steps
                 and launches["lstm_bwd"] == k2_want
                 and launches["lstm_fwd"] == main_launches["lstm_fwd"]
                 and launches_at_units(launches["lstm_fwd_by_shape"],
                                       U) == 0
                 and launches["lstm_bwd_acc"] == main_launches["lstm_bwd_acc"]
                 and launches["lstm_bwd_acc_resident"] == 0
                 and launches["lstm_bwd_acc_streaming"] == 0 and rc == 0
                 and decode_launches > 0 and len(ark) == 16
                 and all(m.shape[1] == OUT and np.isfinite(m).all()
                         for m in ark.values()))
    emit({"phase": "train_lstm", **out})
    return out


def profile_trace(profile_dir: str) -> dict:
    """The --profile_dir trace of one CLI run: exactly one
    ``*.pt.trace.json``, holding kernel events on the card, the resident
    kernels of csrc/resident.cu among them."""
    names = sorted(n for n in (os.listdir(profile_dir)
                               if os.path.isdir(profile_dir) else [])
                   if n.endswith(".pt.trace.json"))
    kernels, resident = 0, 0
    if len(names) == 1:
        with open(os.path.join(profile_dir, names[0])) as f:
            events = json.load(f).get("traceEvents", [])
        for e in events:
            if e.get("cat") == "kernel":
                kernels += 1
                resident += "_resident_kernel" in e.get("name", "")
    return {"traces": names, "kernel_events": kernels,
            "resident_kernel_events": resident,
            "ok": len(names) == 1 and resident > 0}


def snapshot_epochs(train_cli, counters, flags, work):
    """Two epochs with --checkpoint_every_secs=1, the default
    --tensorboard and --profile_dir: each split's events file holds a
    version record and one record per metrics_*.jsonl line, steps the
    iterations, CRCs valid; the periodic snapshot exists, and
    load_newest_state reads it back (made the newest file, as after a
    crash) into a fresh state; the profiler wrote one trace, of the
    second iteration, with the card's kernels in it."""
    import torch
    from rsrgan_tpu_torch.training import (load_newest_state,
                                           periodic_snapshot_path)
    from rsrgan_tpu_torch.training.tensorboard import read_scalar_events
    profile_dir = os.path.join(work, "snapshots_profile")
    argv = flags("snapshots", "--checkpoint_every_secs=1",
                 "--min_epoches=2", "--max_epoches=2",
                 f"--profile_dir={profile_dir}")
    row, cv_row, launches, secs = cli_epoch(train_cli, counters, argv)
    save_dir = os.path.join(work, "snapshots")
    events_ok, records = True, {}
    for split in ("train", "eval"):
        with open(os.path.join(save_dir, f"metrics_{split}.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        names = os.listdir(os.path.join(save_dir, split))
        events = (read_scalar_events(os.path.join(save_dir, split, names[0]))
                  if len(names) == 1 else [])
        records[split] = len(events)
        events_ok = (events_ok and len(events) == 1 + len(rows) == 3
                     and [e["step"] for e in events[1:]]
                     == [r["iteration"] for r in rows] == [1, 2]
                     and all(e["scalars"][k] == np.float32(r[k])
                             for e, r in zip(events[1:], rows)
                             for k in r if k != "iteration"))
    snap = periodic_snapshot_path(save_dir, "GAN_RNN")
    source, step = None, None
    if os.path.isfile(snap):
        os.utime(snap, (time.time() + 5,) * 2)
        trainer = train_cli.build_trainer(
            train_cli.build_parser().parse_args(argv), torch.device("cuda"),
            torch.bfloat16)
        state = trainer.init_state()
        _, source = load_newest_state(save_dir, "GAN_RNN", state)
        step = state.step
    profile = profile_trace(profile_dir)
    out = {"seconds": secs, "event_records": records, "events_ok": events_ok,
           "snapshot": os.path.isfile(snap), "restored_from": source,
           "restored_step": step, "profile": profile}
    out["ok"] = (finite_losses(row, cv_row) and events_ok
                 and source == "periodic" and step is not None and step >= 1
                 and profile["ok"])
    emit({"phase": "train_snapshots", **out})
    return out


def phase_train(work: str, prepared: dict) -> dict:
    """The flagship LSGAN epoch through the CLI, from the prepare phase's
    stores and CMVN: host-fed and device-fed (the main path, bit-equal to
    the host-fed one), graph-fed and conditioned; with dropout
    (--keep_prob=0.8), with --g_type=lstm (and its decode), with periodic
    snapshots and TensorBoard files; decode from the main path's
    checkpoint; the f32 parity; profiled steps; the B=64 step's peak
    memory."""
    import torch
    from rsrgan_tpu_torch.cli import train as train_cli
    from rsrgan_tpu_torch.training import latest_checkpoint

    tr_list, cv_list = prepared["train"], prepared["cv"]
    data_dir = prepared["data_dir"]
    counters = counter_table()

    def flags(tag, *extra):
        return ["--trainer=gan_rnn", "--g_type=res_lstm_l",
                "--batch_size=16", "--min_epoches=1", "--max_epoches=1",
                f"--input_dim={P}", f"--output_dim={OUT}",
                f"--data_dir={data_dir}", f"--tr_list_file={tr_list}",
                f"--cv_list_file={cv_list}", "--seed=5", *extra,
                f"--save_dir={os.path.join(work, tag)}"]

    def losses_of(row, cv_row):
        return {k: v for k, v in {**row, **{"cv_" + k: v for k, v in
                                            cv_row.items()}}.items()
                if k.endswith("loss")}

    # the two feeds in turns (host, device, device, host): the first run
    # also pays the kernels' first launches. The second is the main
    # path: the default flags, which on a card feed from the resident
    # tables (--device_feed=auto).
    runs = {}
    for tag in ("host", "train_exp", "device_2", "host_2"):
        extra = ("--device_feed=off",) if tag.startswith("host") else ()
        runs[tag] = cli_epoch(train_cli, counters, flags(tag, *extra))
    row, cv_row, launches, secs = runs["train_exp"]
    save_dir = os.path.join(work, "train_exp")
    losses = losses_of(row, cv_row)
    ckpt = latest_checkpoint(save_dir, "GAN_RNN")
    with open(ckpt, "rb") as f:
        main_bytes = f.read()
    feeds_equal = True
    for tag, (t_row, t_cv, _, _) in runs.items():
        other = latest_checkpoint(os.path.join(work, tag), "GAN_RNN")
        with open(other, "rb") as f:
            feeds_equal = (feeds_equal and f.read() == main_bytes
                           and losses_of(t_row, t_cv) == losses)

    feed_speeds = {tag: speed(r[0]) for tag, r in runs.items()}
    emit({"phase": "train_feeds", "B": B, "order": list(runs),
          "speed": feed_speeds, "bit_equal": feeds_equal,
          "name, power.limit": card_name_and_limit()})

    variants = {}
    for tag, extra in (("graph_fed", "--same_batch=false"),
                       ("d_conditioned", "--d_conditioned=true")):
        v_row, v_cv, v_launches, _ = cli_epoch(train_cli, counters,
                                               flags(tag, extra))
        v_losses = losses_of(v_row, v_cv)
        variants[tag] = {"losses": v_losses, "launches": v_launches,
                         "steps": v_row["train_steps"],
                         "ok": (on_kernel_routes(v_launches)
                                and all(np.isfinite(x)
                                        for x in v_losses.values()))}

    dropout = dropout_epoch(train_cli, counters, flags, row, launches)
    res_i = res_lstm_i_epoch(train_cli, flags, work, data_dir, cv_list, row,
                             launches)
    lstm = lstm_epoch(train_cli, counters, flags, work, data_dir, cv_list,
                      row, launches)
    snapshots = snapshot_epochs(train_cli, counters, flags, work)

    rc = train_cli.main(["--decode", "--trainer=gan_rnn",
                         "--g_type=res_lstm_l", "--decode_batch_size=16",
                         f"--input_dim={P}", f"--output_dim={OUT}",
                         f"--data_dir={data_dir}",
                         f"--test_list_file={cv_list}",
                         f"--save_dir={save_dir}"])
    torch.cuda.synchronize()
    ark = read_ark(os.path.join(save_dir, "test", "feats.scp"))
    decode_ok = (rc == 0 and len(ark) == 16
                 and all(m.shape[1] == OUT and np.isfinite(m).all()
                         for m in ark.values()))
    parity = train_step_parity(tr_list)
    profile = profile_train_step(tr_list, B, counters)
    # the profiled step's D-step backward on K3's row-group kernels, and
    # none of it on csrc/lstm_bwd.cu (B=16: no G layer reaches K3)
    hand = profile["hand_kernels_ms"]
    k3_rowgroup = (hand["lstm_bwd_rowgroup_kernel"] > 0
                   and hand["lstm_wgrad_kernel"] > 0
                   and hand["lstm_bwd_kernel"] == 0)
    # B=32, the CLI's default: every G layer's backward (4 layers x 2 G
    # steps) on K3's resident route, none on csrc/lstm_bwd.cu
    profile32 = profile_train_step(tr_list, 2 * B, counters)
    hand32, runs32 = profile32["hand_kernels_ms"], profile32["launches"]
    k3_resident = (runs32["lstm_bwd_acc_resident"] == 2 * L
                   and runs32["lstm_bwd_acc_streaming"] == 0
                   and hand32[K3_WALK_BF16_KERNEL] > 0
                   and hand32["lstm_bwd_kernel"] == 0)
    peak64 = step_peak_bytes(tr_list, 4 * B)
    out = {"phase": "train", "seconds": secs, "launches": launches,
           "steps": row["train_steps"], "train_secs": row["train_secs"],
           "train_frames_per_s": row["train_frames_per_sec"],
           "ms_per_iteration": 1e3 * row["train_secs"] / row["train_steps"],
           "feeds": feed_speeds, "feeds_bit_equal": feeds_equal,
           "losses": losses, "checkpoint": os.path.basename(ckpt or ""),
           "variants": variants, "dropout": dropout, "res_lstm_i": res_i,
           "lstm": lstm,
           "snapshots": snapshots,
           "decode_ok": decode_ok, "parity_f32": parity,
           "profile_bf16_step": profile, "k3_rowgroup_in_step": k3_rowgroup,
           "profile_bf16_step_b32": profile32,
           "k3_resident_in_b32_step": k3_resident,
           "step_peak_bytes_b64_t600": peak64,
           "feed_reserve_bytes": train_cli.FEED_RESERVE_BYTES,
           "ok": (on_kernel_routes(launches) and feeds_equal
                  and all(v["ok"] for v in variants.values())
                  and dropout["ok"] and res_i["ok"] and lstm["ok"]
                  and snapshots["ok"]
                  and k3_rowgroup and k3_resident
                  and all(np.isfinite(v) for v in losses.values())
                  and ckpt is not None and decode_ok and parity["ok"]
                  and peak64 < train_cli.FEED_RESERVE_BYTES)}
    emit(out)
    return out


# The MSE and frame trainers (--trainer=rnn, dnn, gan_dnn): the recipes'
# widths (recipes/run_rnn.sh, run_dnn.sh, run_gan_dnn.sh: res_lstm_l at
# B=16; a 4 x 1024 DNN on 11 spliced 257-dim frames, 40 out, B=256).
FRAME_CONTEXT = 5
FRAME_B = 256
# the frame trainers' f32 step on the card against the same step on the
# CPU (G's output and its last layer's gradients): both full f32, other
# summation orders only (~1e-6); TF32 in the card's products (10
# mantissa bits) misses by ~3e-4 in one 2,827-deep product alone
FRAME_STEP_TOL = 1e-4


def counter_table() -> dict:
    """name -> (wrapper, its count[, the route it counts]); lstm_bwd_acc's
    three routes apart (``launches_by_route``): the row-group walk, the
    resident walk, csrc/lstm_bwd.cu; lstm_fwd's two by route name
    (``fwd_route``)."""
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    from rsrgan_tpu_torch.ops import wavefront as wf
    return {"wavefront_fwd_train": (wf.lstm_wavefront_fwd_train, "launches"),
            "lstm_fwd": (ls.lstm_fwd, "launches"),
            "lstm_fwd_by_shape": (ls.lstm_fwd, "launches_by_shape"),
            "lstm_fwd_by_route": (ls.lstm_fwd, "launches_by_route"),
            "lstm_bwd": (ls.lstm_bwd, "launches"),
            "lstm_bwd_acc": (ls.lstm_bwd_acc, "launches_by_route",
                             "rowgroup"),
            "lstm_bwd_acc_resident": (ls.lstm_bwd_acc, "launches_by_route",
                                      "resident"),
            "lstm_bwd_acc_streaming": (ls.lstm_bwd_acc, "launches_by_route",
                                       "streaming"),
            "wavefront_fwd": (wf.lstm_wavefront_fwd, "launches")}


def mse_step_parity(tr_list: str) -> dict:
    """One f32 MseTrainer step (res_lstm_l, B=16) through the kernels and
    through --lstm_impl=scan from one state: a first scan step on another
    batch gives both Adam moments (from zero moments Adam's first step
    moves an element by +-lr on the sign of a near-zero gradient, on
    either side). Gated: the gradients and the post-step params, max
    |diff| / max |ref| per tensor."""
    import torch
    from rsrgan_tpu_torch.data import (SequenceBatcher, UtteranceStore,
                                       read_list_file)
    from rsrgan_tpu_torch.models import get_generator
    from rsrgan_tpu_torch.training import (MseTrainer, load_state_tree,
                                           state_tree)
    store = UtteranceStore(read_list_file(tr_list))
    batches = iter(SequenceBatcher(store, B, seed=1))
    first, second = next(batches), next(batches)

    def arrays(b):
        return [torch.from_numpy(a).cuda() for a in (b.inputs, b.labels,
                                                     b.lengths)]

    trainers, states = {}, {}
    for impl in ("scan", "wavefront"):
        g = get_generator("res_lstm_l", input_dim=P, output_dim=OUT,
                          compute_dtype=torch.float32, lstm_impl=impl,
                          generator=torch.Generator().manual_seed(21))
        trainers[impl] = MseTrainer(g.cuda(), output_dim=OUT, l2_scale=1e-5,
                                    max_grad_norm=15.0)
        states[impl] = trainers[impl].init_state()
    trainers["scan"].train_step(states["scan"], *arrays(first), 5e-4)
    load_state_tree(states["wavefront"], state_tree(states["scan"]))
    for impl, tr in trainers.items():
        tr.grad_log = []
        tr.train_step(states[impl], *arrays(second), 5e-4)
    grads = max(rel_errs(trainers["wavefront"].grad_log[0],
                         trainers["scan"].grad_log[0]).values())
    post = max(rel_errs(states["wavefront"].net.params(),
                        states["scan"].net.params()).values())
    return {"grad_rel_err": grads, "post_step_param_rel_err": post,
            "tol": GRAD_TOL, "ok": grads <= GRAD_TOL and post <= GRAD_TOL}


def decode_checkpoint(train_cli, argv, save_dir, want_utts) -> dict:
    """``--decode`` of a training run's checkpoint through the CLI:
    (ok, wall seconds); ok needs every utterance, OUT wide and finite."""
    import torch
    t0 = time.monotonic()
    rc = train_cli.main(["--decode", *argv])
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    ark = read_ark(os.path.join(save_dir, "test", "feats.scp"))
    ok = (rc == 0 and len(ark) == want_utts
          and all(m.shape[1] == OUT and np.isfinite(m).all()
                  for m in ark.values()))
    return {"ok": ok, "seconds": secs}


def speed_of(train: dict) -> dict:
    """The flagship CLI epoch's speed from the train phase's line."""
    return {"train_frames_per_s": train["train_frames_per_s"],
            "ms_per_iteration": train["ms_per_iteration"]}


# the bnlstm f32 step card vs CPU: the first frames of a B=16 batch
BNLSTM_PARITY_T = 64


def bnlstm_mse(train_cli, counters, flags, tr_list: str, cv_list: str,
               data_dir: str, work: str) -> dict:
    """--trainer=rnn --g_type=bnlstm (recipes/run_rnn.sh's bnlstm arm: 3 x
    BnLstm(760, proj 280) at B=16, bf16 products, the eager cell): one
    epoch through the CLI on its default (device) feed, all of the train
    store's 8 iterations, every hand kernel's count 0 over it; its ms per
    iteration; the CUDA kernels and copies of one train step on the
    shortest bucket (torch.profiler); the f32 step on the card against
    the CPU on that batch's first BNLSTM_PARITY_T frames (the CPU's cell
    at full width takes seconds a frame), from one state with Adam's
    moments off zero (gradients, the state after it with the folded
    batch_stats, the losses; GRAD_TOL); --decode from the epoch's
    checkpoint."""
    import torch
    from rsrgan_tpu_torch.data import (SequenceBatcher, UtteranceStore,
                                       read_list_file)
    from rsrgan_tpu_torch.models import get_generator
    from rsrgan_tpu_torch.training import MseTrainer
    row, cv_row, launches, secs = cli_epoch(
        train_cli, counters, flags("mse_bnlstm", "--g_type=bnlstm"))
    store = UtteranceStore(read_list_file(tr_list))
    first = min(SequenceBatcher(store, B, seed=1),
                key=lambda b: b.inputs.shape[1])

    def trainer(cdt, device="cpu"):
        g = get_generator("bnlstm", input_dim=P, output_dim=OUT,
                          compute_dtype=cdt,
                          generator=torch.Generator().manual_seed(41))
        return MseTrainer(g.to(device), output_dim=OUT, l2_scale=1e-5,
                          max_grad_norm=15.0)

    def arrays(t_max, dev):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            first.inputs[:, :t_max], first.labels[:, :t_max],
            np.minimum(first.lengths, t_max).astype(np.int32))]

    tr = trainer(torch.bfloat16, "cuda")
    st = tr.init_state()
    batch = arrays(first.inputs.shape[1], "cuda")
    tr.train_step(st, *batch, 5e-4)
    window = profile_window(lambda: tr.train_step(st, *batch, 5e-4), 1)
    del tr, st, batch

    def step(tr, st, dev):
        m = tr.train_step(st, *arrays(BNLSTM_PARITY_T, dev), 5e-4)
        return {k: float(v) for k, v in m.items()}

    parity = card_vs_cpu_step(lambda: trainer(torch.float32),
                              lambda tr: tr.init_state(), step,
                              ("generator",))
    parity.update({"T": BNLSTM_PARITY_T, "tol": GRAD_TOL})
    parity["ok"] = all(parity[k] <= GRAD_TOL for k in (
        "metrics_rel_err", "grad_rel_err", "post_step_state_rel_err"))
    save_dir = os.path.join(work, "mse_bnlstm")
    decode = decode_checkpoint(
        train_cli, ["--trainer=rnn", "--g_type=bnlstm",
                    "--decode_batch_size=16", f"--input_dim={P}",
                    f"--output_dim={OUT}", f"--data_dir={data_dir}",
                    f"--test_list_file={cv_list}", f"--save_dir={save_dir}"],
        save_dir, 16)
    out = {"seconds": secs, "speed": speed(row),
           "losses": {k: v for k, v in row.items() if k.endswith("loss")},
           "hand_kernel_launches": hand_launches(launches),
           "profiled_step": {"T": int(first.inputs.shape[1]), **window},
           "parity_f32_card_vs_cpu": parity, "decode": decode}
    out["ok"] = (finite_losses(row, cv_row) and parity["ok"]
                 and decode["ok"] and out["hand_kernel_launches"] == 0)
    return out


def mse_dropout_epoch(train_cli, flags, main_row, cv_batches) -> dict:
    """--trainer=rnn --keep_prob=0.8 on the MSE epoch's batches: G leaves
    the wavefront in training, K1 at G width forward on its resident
    route and K2 backward for each of its 4 layers an iteration, no K4
    train and no D; the cv pass (no dropout) on K4's decode mode as the
    main path's; then K1 and K2 at every G-width shape it launched
    against their twins."""
    row, cv_row, launches, secs = cli_epoch(
        train_cli, chain_counters(), flags("mse_dropout", "--keep_prob=0.8"))
    steps = row["train_steps"]
    k1_g = launches_at_units(launches["lstm_fwd_by_shape"], U)
    checks = g_width_checks((launches,))
    out = {"launches": launches, "k1_g_width_launches": k1_g,
           "k1_g_width_per_iteration": k1_g / steps, "seconds": secs,
           "speed": speed(row), "mse_speed": speed(main_row),
           "losses": {k: v for k, v in row.items() if k.endswith("loss")},
           "g_width_kernels_ok": all(r["ok"] for r in checks)}
    out["ok"] = (finite_losses(row, cv_row)
                 and steps == main_row["train_steps"]
                 and k1_g == L * steps and k1_routes_ok(launches, k1_g, 0)
                 and launches["lstm_bwd"] == L * steps
                 and launches["wavefront_fwd_train"] == 0
                 and launches["wavefront_fwd"] == cv_batches
                 and launches["lstm_bwd_acc"] == 0
                 and launches["lstm_bwd_acc_resident"] == 0
                 and launches["lstm_bwd_acc_streaming"] == 0
                 and out["g_width_kernels_ok"])
    emit({"phase": "train_mse_dropout", **out,
          "name, power.limit": card_name_and_limit()})
    return out


def phase_train_mse(work: str, prepared: dict, flagship) -> dict:
    """--trainer=rnn --g_type=res_lstm_l through the CLI (G alone, MSE;
    recipes/run_rnn.sh's B=16 and lr): one epoch on the device feed (the
    main path: counts set to 0 just before, read after), whose
    iterations must each launch K4 in train mode once and K2 once per G
    layer at U=760 and nothing at D's width; one on the host feed before
    it and one after, whose checkpoints and metrics must be bit-equal to
    it; one at B=32, the CLI's
    default, whose G-layer backwards must all take K3's resident route;
    the f32 step through the kernels against --lstm_impl=scan; --decode
    from the epoch's checkpoint."""
    import torch
    from rsrgan_tpu_torch.cli import train as train_cli
    from rsrgan_tpu_torch.training import latest_checkpoint
    counters = counter_table()
    tr_list, cv_list = prepared["train"], prepared["cv"]
    data_dir = prepared["data_dir"]

    def flags(tag, *extra):
        return ["--trainer=rnn", "--g_type=res_lstm_l", "--batch_size=16",
                "--g_learning_rate=0.0005", "--min_epoches=1",
                "--max_epoches=1", f"--input_dim={P}", f"--output_dim={OUT}",
                f"--data_dir={data_dir}", f"--tr_list_file={tr_list}",
                f"--cv_list_file={cv_list}", "--seed=5", *extra,
                f"--save_dir={os.path.join(work, tag)}"]

    # host, device (the main path), host: the first run pays the
    # trainer's first launches
    runs = {tag: cli_epoch(train_cli, counters, flags(tag, *extra))
            for tag, extra in (("mse_host", ("--device_feed=off",)),
                               ("mse", ()),
                               ("mse_host_2", ("--device_feed=off",)))}
    row, cv_row, launches, secs = runs["mse"]
    steps = row["train_steps"]
    cv_batches = launches["wavefront_fwd"]
    main_ok = (launches["wavefront_fwd_train"] == steps
               and launches["lstm_bwd"] == L * steps
               and launches["lstm_fwd"] == 0 and launches["lstm_bwd_acc"] == 0
               and cv_batches > 0)
    ckpts = {}
    for tag in runs:
        with open(latest_checkpoint(os.path.join(work, tag), "RNNTrainer"),
                  "rb") as f:
            ckpts[tag] = f.read()
    losses = {tag: {(split + k): v
                    for split, r in (("", r_[0]), ("cv_", r_[1]))
                    for k, v in r.items() if k.endswith("loss")}
              for tag, r_ in runs.items()}
    feeds_equal = all(ckpts[t] == ckpts["mse"] and losses[t] == losses["mse"]
                      and runs[t][0]["train_steps"] == steps for t in runs)

    row32, cv32, launches32, _ = cli_epoch(
        train_cli, counters, flags("mse_b32", "--batch_size=32"))
    steps32 = row32["train_steps"]
    k3_ok = (launches32["lstm_bwd_acc_resident"] == L * steps32
             and launches32["lstm_bwd_acc"] == 0
             and launches32["lstm_bwd_acc_streaming"] == 0
             and launches32["lstm_bwd"] == 0 and launches32["lstm_fwd"] == 0
             and launches32["wavefront_fwd_train"] == steps32)
    dropout = mse_dropout_epoch(train_cli, flags, row, cv_batches)
    parity = mse_step_parity(tr_list)
    bnlstm = bnlstm_mse(train_cli, counters, flags, tr_list, cv_list,
                        data_dir, work)
    decode = decode_checkpoint(
        train_cli, ["--trainer=rnn", "--g_type=res_lstm_l",
                    "--decode_batch_size=16", f"--input_dim={P}",
                    f"--output_dim={OUT}", f"--data_dir={data_dir}",
                    f"--test_list_file={cv_list}",
                    f"--save_dir={os.path.join(work, 'mse')}"],
        os.path.join(work, "mse"), 16)
    out = {"phase": "train_mse", "seconds": secs, "launches": launches,
           "launches_per_iteration": {
               k: launches[k] / steps for k in ("wavefront_fwd_train",
                                                "lstm_bwd", "lstm_fwd",
                                                "lstm_bwd_acc")},
           "cv_batches": cv_batches, "speed": speed(row),
           "host_feed_speed": [speed(runs[t][0])
                               for t in ("mse_host", "mse_host_2")],
           "flagship_speed": flagship, "feeds_bit_equal": feeds_equal,
           "losses": losses["mse"], "b32": {
               "launches": launches32, "speed": speed(row32),
               "k3_resident_route": k3_ok},
           "parity_f32": parity, "decode": decode, "bnlstm": bnlstm,
           "dropout": dropout, "name, power.limit": card_name_and_limit()}
    out["ok"] = (main_ok and feeds_equal and k3_ok and parity["ok"]
                 and decode["ok"] and finite_losses(row, cv_row)
                 and finite_losses(row32, cv32) and bnlstm["ok"]
                 and dropout["ok"])
    emit(out)
    return out


def frame_step_parity(make_gen, last: str, rows: int, store_list: str,
                      seed: int, tf32: bool = False) -> dict:
    """One f32 MseTrainer step (frame mode) of a frame model on the card
    and the same step on the CPU, from one seeded init, on the first
    ``rows`` frames of the store's frame batcher. Gated, max |diff| / max
    |ref| per tensor: G's output before the step and the gradients of
    its last (output) layer ``last``, both continuous in the inputs, so
    two f32 runs agree to rounding while TF32 (10 mantissa bits) misses
    by ~1e-4 to 1e-3. Reported: every gradient and the post-step params.
    A hidden layer's gradient passes ReLU's step derivative: where a
    pre-activation lies within rounding of 0 (about one of the DNN's ~1
    M a step), the two runs take different sides and that unit's row
    moves by ~1e-3 of the tensor's largest entry, on the CPU in f32
    against f64 as much as on the card; Adam's first step then takes the
    sign of a near-zero gradient. ``tf32``: the card's step with TF32 on
    (the CLI's precision restored after it), to show the gate sees it."""
    import torch
    from rsrgan_tpu_torch.cli.train import set_precision
    from rsrgan_tpu_torch.data import (FrameBatcher, UtteranceStore,
                                       read_list_file)
    from rsrgan_tpu_torch.training import MseTrainer
    batcher = FrameBatcher(UtteranceStore(read_list_file(store_list)), rows,
                           FRAME_CONTEXT, FRAME_CONTEXT, seed=seed)
    x, y = next(iter(batcher))
    out = {}
    for dev in ("cpu", "cuda"):
        if tf32 and dev == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        tr = MseTrainer(make_gen().to(dev), output_dim=OUT, l2_scale=1e-5,
                        sequence_mode=False)
        st = tr.init_state()
        xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        with torch.no_grad():
            g_out = tr.generator(xd).cpu()
        tr.grad_log = []
        tr.train_step(st, xd, yd, None, 1e-3)
        out[dev] = ({"out": g_out},
                    {k: v.cpu() for k, v in tr.grad_log[0].items()},
                    {k: v.detach().cpu() for k, v in st.net.params().items()})
    set_precision()
    errs = [rel_errs(card, cpu) for card, cpu in zip(out["cuda"],
                                                     out["cpu"])]
    gated = {"out": errs[0]["out"],
             **{k: v for k, v in errs[1].items() if k.startswith(last)}}
    return {"rows": rows, "tf32": tf32, "gated_rel_err": gated,
            "grad_rel_err": errs[1],
            "post_step_param_rel_err": max(errs[2].values()),
            "tol": FRAME_STEP_TOL,
            "ok": max(gated.values()) <= FRAME_STEP_TOL}


def phase_train_frame(work: str, prepared: dict) -> dict:
    """The frame trainers through the CLI, in f32, TF32 turned on for the
    process first so that only the CLI's own setting turns it off:
    --trainer=dnn and --trainer=gan_dnn at the recipes' width (4 x 1024
    on 11 spliced 257-dim frames, 40 out, B=256) for one epoch over the
    train store; --g_type=rced and --g_type=cnn at full width for one
    epoch of the 16-utterance cv store (as train and cv); each with
    finite losses, a checkpoint and --decode from it; frames/s; then the
    DNN's (256 rows) and R-CED's (8 rows) f32 step on the card against
    the CPU."""
    import torch
    from rsrgan_tpu_torch.cli import train as train_cli
    from rsrgan_tpu_torch.models import get_generator
    counters = counter_table()
    tr_list, cv_list = prepared["train"], prepared["cv"]
    data_dir = prepared["data_dir"]
    model = [f"--input_dim={P}", f"--output_dim={OUT}",
             f"--left_context={FRAME_CONTEXT}",
             f"--right_context={FRAME_CONTEXT}"]
    runs = {}
    for tag, trainer, g_type, lists, extra in (
            ("dnn", "dnn", "dnn", (tr_list, cv_list),
             ("--g_learning_rate=0.001",)),
            ("gan_dnn", "gan_dnn", "dnn", (tr_list, cv_list),
             ("--g_learning_rate=0.0001", "--d_learning_rate=0.0001",
              "--init_mse_weight=10.0")),
            ("rced", "dnn", "rced", (cv_list, cv_list),
             ("--g_learning_rate=0.001",)),
            ("cnn", "dnn", "cnn", (cv_list, cv_list),
             ("--g_learning_rate=0.001",))):
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        save_dir = os.path.join(work, f"frame_{tag}")
        argv = [f"--trainer={trainer}", f"--g_type={g_type}", *model,
                f"--data_dir={data_dir}", f"--save_dir={save_dir}"]
        row, cv_row, launches, secs = cli_epoch(
            train_cli, counters, argv + [
                f"--batch_size={FRAME_B}", "--min_epoches=1",
                "--max_epoches=1", f"--tr_list_file={lists[0]}",
                f"--cv_list_file={lists[1]}", "--seed=5", *extra])
        tf32_off = not (torch.backends.cuda.matmul.allow_tf32
                        or torch.backends.cudnn.allow_tf32)
        name = train_cli.model_name(train_cli.build_parser().parse_args(
            argv))
        ckpt = os.path.isfile(os.path.join(save_dir, f"{name}-1.ckpt"))
        decode = decode_checkpoint(train_cli, argv + [
            f"--test_list_file={cv_list}"], save_dir, 16)
        runs[tag] = {"speed": speed(row), "seconds": secs,
                     "losses": {k: v for k, v in row.items()
                                if k.endswith("loss")},
                     "cv_g_loss": cv_row["g_loss"], "checkpoint": ckpt,
                     "decode": decode, "tf32_off_after_cli": tf32_off,
                     "lstm_launches": sum(v for v in launches.values()
                                          if isinstance(v, int)),
                     "ok": (finite_losses(row, cv_row) and ckpt
                            and decode["ok"] and tf32_off)}
    def dnn():
        return get_generator("dnn", input_dim=P, output_dim=OUT,
                             left_context=FRAME_CONTEXT,
                             right_context=FRAME_CONTEXT,
                             generator=torch.Generator().manual_seed(51))

    def rced():
        return get_generator("rced", input_dim=P, output_dim=OUT,
                             left_context=FRAME_CONTEXT,
                             right_context=FRAME_CONTEXT,
                             generator=torch.Generator().manual_seed(52))

    # the card's steps run under the precision the last CLI call set
    parity = {"dnn": frame_step_parity(dnn, "Dense_4.", FRAME_B, cv_list, 7),
              "rced": frame_step_parity(rced, "Dense_0.", 8, cv_list, 8)}
    tf32 = frame_step_parity(dnn, "Dense_4.", FRAME_B, cv_list, 7, tf32=True)
    tf32["ok"] = not tf32["ok"]   # the gate must see TF32
    out = {"phase": "train_frame", "B": FRAME_B, "runs": runs,
           "parity_f32_card_vs_cpu": parity, "tf32_caught": tf32,
           "name, power.limit": card_name_and_limit()}
    out["ok"] = (all(r["ok"] for r in runs.values())
                 and all(p["ok"] for p in parity.values()) and tf32["ok"])
    emit(out)
    return out


def profile_window(fn, reps: int) -> dict:
    """``reps`` calls of fn() under torch.profiler, ending in a
    synchronize: per call the wall ms, the device ms of the CUDA kernels
    and copies, their counts, and the device's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in events if e.name.startswith(("Memcpy", "Memset"))]
    device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps
    return {"calls": reps, "wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "cuda_kernels": (len(events) - len(copies)) / reps,
            "cuda_copies": len(copies) / reps}


def card_vs_cpu_step(make_trainer, init, step, names) -> dict:
    """One f32 train step of a trainer on the card and the same step on
    the CPU, from one state (made on the CPU, copied to the card):
    ``make_trainer()`` builds it on the CPU, ``init(trainer)`` its state
    (the CPU's, with its nets' optimizer moments off zero, is what the
    card's run loads), ``step(trainer, state, device)`` runs the step and
    returns its metrics. Max |diff| / max |ref| (the CPU's) per tensor of the
    gradients (``grad_log``), of the whole state after the step
    (``state_tree``: params, optimizer moments, EMA, the mutable
    collections) and of the metrics."""
    import torch
    from rsrgan_tpu_torch.models import flatten_tree
    from rsrgan_tpu_torch.tools.step_conditioning import moments_off_zero
    from rsrgan_tpu_torch.training import load_state_tree, state_tree
    t0 = time.monotonic()
    out = {}
    start = None
    for dev in ("cpu", "cuda"):
        tr = make_trainer()
        if dev == "cuda":
            for net in names:
                getattr(tr, net).cuda()
        st = init(tr)
        if start is None:
            for i, net in enumerate(("net",) if hasattr(st, "net")
                                    else ("g", "d")):
                moments_off_zero(getattr(st, net), 71 + i)
            start = state_tree(st)
        else:
            load_state_tree(st, start)
        tr.grad_log = []
        metrics = step(tr, st, torch.device(dev))
        grads = {}
        for i, entry in enumerate(tr.grad_log):
            tag, g = entry if isinstance(entry, tuple) else ("g", entry)
            grads.update({f"{i}:{tag}:{k}": v.cpu() for k, v in g.items()})
        out[dev] = ({k: torch.as_tensor(float(v)) for k, v in
                     metrics.items()}, grads,
                    {k: torch.from_numpy(np.asarray(v, np.float32))
                     for k, v in flatten_tree(state_tree(st)).items()
                     if v is not None})
    errs = [rel_errs(card, cpu) for card, cpu in zip(out["cuda"],
                                                     out["cpu"])]
    return {"metrics_rel": errs[0], "metrics_rel_err": max(errs[0].values()),
            "grad_rel_err": max(errs[1].values()),
            "worst_grad": max(errs[1], key=errs[1].get),
            "post_step_state_rel_err": max(errs[2].values()),
            "worst_state": max(errs[2], key=errs[2].get),
            "collections_rel_err": max([v for k, v in errs[2].items()
                                        if ".extra." in k] or [0.0]),
            "seconds": time.monotonic() - t0}


# recipes/run_segan.sh: the conv auto-encoder G (kwidth 20, the default
# --g_enc_depths 16..1024, bias on the deconvolutions), the VBN conv D
# (kwidth 31), 7 spliced 257-dim frames (context 3 + 3) to 40, B=256,
# RMSProp at 1e-3 for both nets, 1 D + 1 G update, L1 weight 100.
SEGAN_CONTEXT = 3
SEGAN_B = 256
SEGAN_FLAGS = ["--trainer=segan", "--g_type=ae", f"--batch_size={SEGAN_B}",
               "--g_learning_rate=0.001", "--d_learning_rate=0.001",
               "--disc_updates=1", "--gen_updates=1", "--bias_deconv=True",
               "--init_l1_weight=100.0", "--deconv_type=deconv",
               f"--input_dim={P}", f"--output_dim={OUT}",
               f"--left_context={SEGAN_CONTEXT}",
               f"--right_context={SEGAN_CONTEXT}"]
SEGAN_HP = {"g_lr": 1e-3, "d_lr": 1e-3, "l1_lambda": 100.0,
            "disc_noise_std": 0.05}
# SEGAN's f32 step on the card against the same step on the CPU: both
# full f32 (TF32 off), one state (the optimizer moments off zero), the
# same z and noise. G's forward and D's losses before its update are
# well conditioned: cuDNN picks its own algorithm for each convolution,
# and other summation orders leave ~1e-6 (gated at SEGAN_FORWARD_TOL).
# The gradients, the state after the step and G's losses (taken after
# D's update) are not: VBN divides by
# sqrt(eps + E[x^2] - E[x]^2), which cancels where a channel's mean
# dwarfs its spread, and the G update's gradient passes a D that its
# RMSProp step has just moved. The CPU's own f32 step of the auto-encoder
# SEGAN lies 1.03e-2 of a tensor's largest entry from its f64 step, in a
# gradient and in a post-step parameter (tools/step_conditioning.py,
# 256 rows); they are gated at SEGAN_STEP_TOL, 5x that. A wiring, padding
# or kernel-flip fault gives O(1).
SEGAN_FORWARD_TOL = 1e-4
SEGAN_STEP_TOL = 5e-2
# the wave generator's step (10 dilated blocks over 1 + 1024 channels of
# W = 1799 positions; z alone is 1,024 x 1,799 floats a row): 64 rows
SEGAN_WAVE_B = 64


def segan_trainer(wave: bool, seed: int):
    """run_segan.sh's SEGAN trainer on the CPU, seeded weights: the AE
    generator, or with ``wave`` the WaveNet-style one."""
    import torch
    from rsrgan_tpu_torch.cli import train as train_cli
    args = train_cli.build_parser().parse_args(
        SEGAN_FLAGS + (["--g_type=wave"] if wave else [])
        + [f"--seed={seed}"])
    return train_cli.build_trainer(args, torch.device("cpu"), torch.float32)


def segan_step_parity(tr_list: str, wave: bool, rows: int) -> dict:
    """One f32 SeganTrainer.train_step on the card against the CPU from
    one state (init_state on the first ``rows`` frames of the store's
    frame batcher, on the CPU), z and D's noise drawn from one seeded CPU
    generator in both runs; G's forward with z = 0 too. Gated: G's
    forward and D's losses (before its update) at SEGAN_FORWARD_TOL;
    every gradient, the whole state after the step (D's vbn_stats
    included) and G's losses (after D's update) at SEGAN_STEP_TOL."""
    import torch
    from rsrgan_tpu_torch.data import (FrameBatcher, UtteranceStore,
                                       read_list_file)
    batcher = FrameBatcher(UtteranceStore(read_list_file(tr_list)), rows,
                           SEGAN_CONTEXT, SEGAN_CONTEXT, seed=7)
    x, y = next(iter(batcher))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    fwd = {}

    def init(tr):
        return tr.init_state(xt.to(next(tr.generator.parameters()).device))

    def step(tr, st, dev):
        draws = torch.Generator().manual_seed(11)
        with torch.no_grad():
            fwd[dev.type] = tr.generator(xt.to(dev)).cpu()
        m = tr.train_step(st, xt.to(dev), yt.to(dev), SEGAN_HP,
                          lambda shape: torch.randn(shape, generator=draws))
        return {k: float(v) for k, v in m.items()}

    out = card_vs_cpu_step(lambda: segan_trainer(wave, 61), init, step,
                           ("generator", "discriminator"))
    out["forward_rel_err"] = max(rel_errs({"g": fwd["cuda"]},
                                          {"g": fwd["cpu"]}).values())
    out.update({"rows": rows, "forward_tol": SEGAN_FORWARD_TOL,
                "step_tol": SEGAN_STEP_TOL})
    d_losses = max(v for k, v in out["metrics_rel"].items()
                   if k.startswith("d_"))
    out["ok"] = (max(out["forward_rel_err"], d_losses) <= SEGAN_FORWARD_TOL
                 and max(out["grad_rel_err"], out["post_step_state_rel_err"],
                         out["metrics_rel_err"]) <= SEGAN_STEP_TOL)
    return out


def segan_stores(prepared: dict, work: str) -> dict:
    """The prepare phase's train and cv stores with labels that G can
    learn: each frame's 40 labels a fixed function of its 257 inputs
    (tanh of a seeded projection). The prepare stores' labels are noise,
    independent of the inputs: on them L1 cannot fall, SEGAN's first
    epoch raises the CV loss and is rejected, and with no earlier
    checkpoint to roll back to the CLI exits 1 (as the JAX CLI does)."""
    from rsrgan_tpu_torch.data import (StoreWriter, UtteranceStore,
                                       read_list_file)
    proj = (np.random.default_rng(17).normal(size=(P, OUT))
            / np.sqrt(P)).astype(np.float32)
    out_dir = os.path.join(work, "segan_data")
    os.makedirs(out_dir)
    lists = {}
    for split in ("train", "cv"):
        store = UtteranceStore(read_list_file(prepared[split]))
        path = os.path.join(out_dir, f"{split}.rtu")
        with StoreWriter(path) as w:
            for i, utt in enumerate(store.utt_ids):
                x = np.asarray(store.inputs(i))
                w.add(utt, x, 1.5 * np.tanh(x @ proj))
        lists[split] = os.path.join(out_dir, f"{split}.list")
        with open(lists[split], "w") as f:
            f.write(path + "\n")
    return lists


def phase_segan(work: str, prepared: dict) -> dict:
    """--trainer=segan at recipes/run_segan.sh's configuration: the f32
    step on the card against the CPU (B=256); one epoch of the CLI over
    the train store's frames with learnable labels (``segan_stores``;
    finite losses, the epoch accepted, no hand kernel launched, TF32 off
    after it) and --decode from its checkpoint (one finite 40-wide matrix
    per cv utterance); its ms per iteration and frames/s, and the busy
    share of 3 profiled steps; then the WaveNet-style G's step against
    the CPU (SEGAN_WAVE_B rows)."""
    import torch
    from rsrgan_tpu_torch.cli import train as train_cli
    from rsrgan_tpu_torch.data import (FrameBatcher, UtteranceStore,
                                       read_list_file)
    counters = counter_table()
    tr_list, data_dir = prepared["train"], prepared["data_dir"]
    t0 = time.monotonic()
    parity = segan_step_parity(tr_list, wave=False, rows=SEGAN_B)
    learnable = segan_stores(prepared, work)
    cv_list = learnable["cv"]
    save_dir = os.path.join(work, "segan")
    argv = SEGAN_FLAGS + [f"--data_dir={data_dir}", f"--save_dir={save_dir}"]
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    row, cv_row, launches, secs = cli_epoch(train_cli, counters, argv + [
        "--min_epoches=1", "--max_epoches=1",
        f"--tr_list_file={learnable['train']}", f"--cv_list_file={cv_list}",
        "--seed=5"])
    tf32_off = not (torch.backends.cuda.matmul.allow_tf32
                    or torch.backends.cudnn.allow_tf32)
    ckpt = os.path.isfile(os.path.join(save_dir, "SEGAN-1.ckpt"))
    decode = decode_checkpoint(train_cli, argv + [
        f"--test_list_file={cv_list}"], save_dir, 16)

    # the busy share of the step the epoch ran: 3 steps, after one
    trainer = segan_trainer(False, 5)
    trainer.generator.cuda()
    trainer.discriminator.cuda()
    x, y = next(iter(FrameBatcher(UtteranceStore(read_list_file(tr_list)),
                                  SEGAN_B, SEGAN_CONTEXT, SEGAN_CONTEXT)))
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    state = trainer.init_state(x)
    rand = torch.Generator(device="cuda").manual_seed(3)
    trainer.train_step(state, x, y, SEGAN_HP, rand)
    window = profile_window(
        lambda: trainer.train_step(state, x, y, SEGAN_HP, rand), 3)
    del trainer, state

    wave = segan_step_parity(tr_list, wave=True, rows=SEGAN_WAVE_B)
    out = {"phase": "segan", "B": SEGAN_B, "seconds": time.monotonic() - t0,
           "epoch_seconds": secs, "parity_f32_card_vs_cpu": parity,
           "speed": speed(row),
           "losses": {k: v for k, v in row.items() if k.endswith("loss")},
           "cv_losses": {k: v for k, v in cv_row.items()
                         if k.endswith("loss")},
           "checkpoint": ckpt, "decode": decode,
           "tf32_off_after_cli": tf32_off,
           "hand_kernel_launches": hand_launches(launches),
           "optim_launches": launches["optim"],
           "profiled_steps": window, "wave_parity_f32_card_vs_cpu": wave,
           "name, power.limit": card_name_and_limit()}
    out["ok"] = (parity["ok"] and wave["ok"] and finite_losses(row, cv_row)
                 and ckpt and decode["ok"] and tf32_off
                 and out["hand_kernel_launches"] == 0)
    emit(out)
    return out


# The parallel phase: data parallelism (rsrgan_tpu_torch/parallel) on the
# card. run_gan_rnn.sh trains at --batch_size=8 a rank (--num_gpu=4); two
# ranks here share the first card over gloo (NCCL refuses two ranks on one
# device), each a process with its own CUDA context, time-slicing the
# card. PAR_TIMED_STEPS library steps are timed after the checked one.
# Every kernel is then held against its twin at each shape a rank
# launched it at (PAR_KERNELS; shape_key's sizes).
PAR_B = 8
PAR_RANKS = 2
PAR_TIMED_STEPS = 4
# run_gan_rnn.sh's training flags, less --num_gpu=4, the data and the
# epochs (the graph-fed loop: D and G steps on successive batches)
GAN_RNN_RECIPE = ["--trainer=gan_rnn", "--same_batch=false",
                  "--g_type=res_lstm_l", f"--batch_size={PAR_B}",
                  "--g_learning_rate=0.00008", "--d_learning_rate=0.0008",
                  "--disc_updates=1", "--gen_updates=2",
                  "--batch_norm=False", "--l2_scale=1e-7",
                  "--init_mse_weight=10.0", f"--input_dim={P}",
                  f"--output_dim={OUT}", "--left_context=0",
                  "--right_context=0", "--end_improve=0.001",
                  "--init_disc_noise_std=0.05"]
# Each rank's launches in one flagship step at PAR_B rows (G) and 2 PAR_B
# rows (D's step): K4 train for the shared G forward and the second G
# step's; K1 for D's 2 layers in the D step and in each G step's D head;
# K2 for D's 2 layers in each of the 3 updates and G's 4 layers in each
# G step (16 rows is below K3's 32); no K3.
PAR_RANK_LAUNCHES = {"wavefront_fwd_train": 2, "lstm_fwd": 6,
                     "lstm_bwd": 14, "lstm_bwd_acc": 0}
# One process at 2 PAR_B: the D step's backward (32 rows) on K3 instead.
PAR_ONE_LAUNCHES = {"wavefront_fwd_train": 2, "lstm_fwd": 6,
                    "lstm_bwd": 12, "lstm_bwd_acc": 2}
PROCESS_TIMEOUT = 300
PAR_KERNELS = ("wavefront_fwd_train", "wavefront_fwd", "lstm_fwd",
               "lstm_bwd", "lstm_bwd_acc")
# a process of the training CLI with its launches counted
COUNTED_CLI = ("import sys, chip_smoke; "
               "sys.exit(chip_smoke.counted_train_cli(sys.argv[1], "
               "sys.argv[2:]))")


def flagship_step(x, y, lens, timed_steps: int,
                  tensor_parallel: bool = False, dtype=None) -> dict:
    """The flagship step (res_lstm_l G, LSTM-D, full width, f32 unless
    ``dtype``, noise std 0) on the kernels, on this process's rows of (x,
    y, lens), in its world: seeded weights placed by ``shard_state``
    (replicated from rank 0; with ``tensor_parallel`` each rank keeps its
    model block of the cells' EMA and Adam moments); the metrics, the
    gradients of the 3 updates and the params after the step (on the
    host), the step's launches in total and by shape (counts set to 0
    just before it), the bytes of each net's EMA and optimizer moments
    and whether each sharded leaf's hold 1/m of its elements, then
    ``timed_steps`` more steps timed with the share of wall time spent
    inside collectives."""
    import torch
    from rsrgan_tpu_torch.models import get_discriminator, get_generator
    from rsrgan_tpu_torch.parallel import (current_world, shard_batch,
                                           shard_state)
    from rsrgan_tpu_torch.training import GanTrainer, default_hparams
    world = current_world()
    device = world.device
    cdt = torch.float32 if dtype is None else dtype
    gen = torch.Generator().manual_seed(21)
    g = get_generator("res_lstm_l", input_dim=P, output_dim=OUT,
                      compute_dtype=cdt, lstm_impl="wavefront",
                      generator=gen).to(device)
    d = get_discriminator("lstm", compute_dtype=cdt,
                          lstm_impl="wavefront", generator=gen).to(device)
    trainer = GanTrainer(g, d, output_dim=OUT, input_dim=P, l2_scale=1e-5)
    state = shard_state(world, trainer.init_state(),
                        tensor_parallel=tensor_parallel)
    x, y, lens = (torch.from_numpy(a).to(device)
                  for a in shard_batch(world, (x, y, lens)))
    hp = dict(default_hparams(), disc_noise_std=0.0)
    counters = chain_counters()
    trainer.grad_log = []
    torch.cuda.synchronize(device)
    reset_counts(counters)
    metrics = trainer.train_step(state, x, y, lens, hp)
    torch.cuda.synchronize(device)
    launches = read_counts(counters)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": [(tag, {k: v.cpu() for k, v in gr.items()})
                     for tag, gr in trainer.grad_log],
           "params": {net: {k: v.detach().cpu() for k, v in
                            getattr(state, net).params().items()}
                      for net in ("g", "d")},
           "launches": {k: launches[k] for k in PAR_RANK_LAUNCHES},
           "by_shape": by_shape(launches), "state_bytes": {},
           "sharded_leaves": {}, "blocks_ok": True}
    for net in ("g", "d"):
        ns = getattr(state, net)
        kept = [ns.ema] + [ns.opt_state[f] for f in ("mu", "nu")
                           if f in ns.opt_state]
        out["state_bytes"][net] = sum(t.numel() * t.element_size()
                                      for tree in kept
                                      for t in tree.values())
        out["sharded_leaves"][net] = len(ns.shards)
        out["blocks_ok"] &= all(
            tree[k].numel() * world.model == p.numel()
            for k, p in ns.params().items() if k in ns.shards
            for tree in kept)
    trainer.grad_log = None
    if timed_steps:
        world.timed, world.collective_secs = True, 0.0
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            trainer.train_step(state, x, y, lens, hp)
        torch.cuda.synchronize(device)
        secs = time.perf_counter() - t0
        world.timed = False
        out["ms_per_step"] = 1e3 * secs / timed_steps
        out["collective_share"] = world.collective_secs / secs
    return out


def by_shape(counts: dict) -> dict:
    """The counts by shape of PAR_KERNELS' wrappers."""
    return {f"{k}_by_shape": counts[f"{k}_by_shape"] for k in PAR_KERNELS}


def _parallel_rank(rank: int, world: int, address: str, work: str,
                   per_card: bool) -> int:
    """One rank of the parallel phase's library step (a spawned process):
    its card (``cuda:rank`` with ``per_card``, else the first card, which
    the ranks share), the world, ``flagship_step`` on its rows; rank 0
    saves its gradients and params, every rank its launches and times."""
    import torch
    from rsrgan_tpu_torch.parallel import initialize, make_world, shutdown
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", rank if per_card else 0)
    initialize(address, world, rank, device)
    try:
        w = make_world(device)
        batch = np.load(os.path.join(work, "parallel_batch.npz"))
        out = flagship_step(batch["x"], batch["y"], batch["lens"],
                            PAR_TIMED_STEPS)
        if rank == 0:
            torch.save({k: out[k] for k in ("grads", "params")},
                       os.path.join(work, "parallel_rank0.pt"))
        with open(os.path.join(work, f"parallel_rank{rank}.json"), "w") as f:
            json.dump({"launches": out["launches"],
                       "by_shape": out["by_shape"], "backend": w.backend,
                       "device": str(device),
                       "ms_per_step": out["ms_per_step"],
                       "collective_share": out["collective_share"]}, f)
        return 0
    finally:
        shutdown()


def parallel_library_step(tr_list: str, work: str, ranks: int,
                          per_card: bool) -> dict:
    """(a) The flagship step on ``ranks`` ranks (a card each with
    ``per_card``, over nccl; else all on the first card, over gloo), each
    on its PAR_B rows of a ``ranks`` PAR_B batch, against the one-process
    step on the whole batch on the card: the 3 updates' gradients and D's
    post-step params gated at GRAD_TOL (max |diff| / max |ref| per
    tensor), G's post-step params reported only (Adam's first step:
    update = g / (|g| + eps)); each rank's launches against the
    local-row routes, and by shape. Returns (that summary, the
    one-process step, rank 0's step)."""
    import torch
    from rsrgan_tpu_torch.data import (SequenceBatcher, UtteranceStore,
                                       read_list_file)
    from rsrgan_tpu_torch.parallel import launch, make_world
    work = os.path.join(work, "parallel_nccl" if per_card else "parallel")
    os.makedirs(work, exist_ok=True)
    store = UtteranceStore(read_list_file(tr_list))
    batch = next(iter(SequenceBatcher(store, ranks * PAR_B, seed=1)))
    np.savez(os.path.join(work, "parallel_batch.npz"), x=batch.inputs,
             y=batch.labels, lens=batch.lengths)
    make_world(torch.device("cuda", 0))
    ref = flagship_step(batch.inputs, batch.labels, batch.lengths,
                        PAR_TIMED_STEPS)
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    rc = launch(_parallel_rank, ranks, args=(work, per_card),
                timeout=PROCESS_TIMEOUT)
    secs = time.monotonic() - t0
    if rc != 0:
        raise RuntimeError(f"a rank of the library step exited {rc}")
    got = torch.load(os.path.join(work, "parallel_rank0.pt"))
    per_rank = []
    for r in range(ranks):
        with open(os.path.join(work, f"parallel_rank{r}.json")) as f:
            per_rank.append(json.load(f))
    names = ("d_step", "g_step_1", "g_step_2")
    grad_errs = {n: max(rel_errs(a[1], b[1]).values())
                 for n, a, b in zip(names, got["grads"], ref["grads"])}
    post = {net: max(rel_errs(got["params"][net],
                              ref["params"][net]).values())
            for net in ("g", "d")}
    routes_ok = (ref["launches"] == PAR_ONE_LAUNCHES
                 and all(r["launches"] == PAR_RANK_LAUNCHES
                         for r in per_rank))
    return {"ranks": ranks, "rows_per_rank": PAR_B,
            "t_pad": int(batch.inputs.shape[1]),
            "rank0_lengths": [int(n) for n in batch.lengths[:PAR_B]],
            "backend": per_rank[0]["backend"],
            "devices": [r["device"] for r in per_rank],
            "grad_rel_err": grad_errs, "post_step_param_rel_err": post,
            "tol": GRAD_TOL, "launches_per_rank": [r["launches"]
                                                   for r in per_rank],
            "launches_one_process": ref["launches"],
            "by_shape_per_rank": [r["by_shape"] for r in per_rank],
            "ms_per_step_ranks": [r["ms_per_step"] for r in per_rank],
            "collective_share_ranks": [r["collective_share"]
                                       for r in per_rank],
            "ms_per_step_one_process": ref["ms_per_step"],
            "launch_seconds": secs,
            "ok": (len(grad_errs) == 3
                   and all(e <= GRAD_TOL for e in grad_errs.values())
                   and post["d"] <= GRAD_TOL and routes_ok)}, ref, got


def counted_train_cli(counts_path: str, argv: list) -> int:
    """The training CLI's ``main(argv)`` in this process, every launch
    count set to 0 just before it and written to ``counts_path`` (JSON)
    just after: the counts of one rank of a --coordinator_address run."""
    import torch
    from rsrgan_tpu_torch.cli import train as train_cli
    counters = chain_counters()
    reset_counts(counters)
    rc, optim_counts = with_optim_counts(lambda: train_cli.main(argv))
    with open(counts_path, "w") as f:
        json.dump({**read_counts(counters), "optim": optim_counts}, f)
    return rc


def cli_processes(argv_of, count: int, counts_dir=None,
                  shared_card: bool = True) -> tuple:
    """``count`` processes of the training CLI with ``argv_of(i)``, from
    the checkout, each with a time limit, every one ended on the way out:
    (exit codes, outputs, seconds, each process's launch counts).
    ``shared_card``: every process sees only the first card, which its
    ranks then share. With ``counts_dir`` each process runs the CLI
    through ``counted_train_cli``; without, its counts are None."""
    env = dict(os.environ, PYTHONPATH=HERE)
    if shared_card:
        env["CUDA_VISIBLE_DEVICES"] = env.get("CUDA_VISIBLE_DEVICES",
                                              "0").split(",")[0]

    def command(i):
        if counts_dir is None:
            return [sys.executable, "-m", "rsrgan_tpu_torch.cli.train",
                    *argv_of(i)]
        return [sys.executable, "-c", COUNTED_CLI,
                os.path.join(counts_dir, f"counts{i}.json"), *argv_of(i)]

    if counts_dir is not None:
        os.makedirs(counts_dir, exist_ok=True)
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        command(i), cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(count)]
    try:
        outs = [p.communicate(timeout=PROCESS_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    counts = None
    if counts_dir is not None and codes == [0] * count:
        counts = []
        for i in range(count):
            with open(os.path.join(counts_dir, f"counts{i}.json")) as f:
                counts.append(json.load(f))
    return codes, outs, time.monotonic() - t0, counts


def coordinator_flags(port: int, i: int, count: int = PAR_RANKS) -> list:
    return [f"--coordinator_address=127.0.0.1:{port}",
            f"--num_processes={count}", f"--process_id={i}"]


def parallel_cli(prepared: dict, work: str) -> dict:
    """(b) run_gan_rnn.sh's flags at --batch_size=8, bf16, one epoch, as
    two processes (--coordinator_address) on the first card: both exit 0,
    the coordinator names the backend (gloo), only it writes (one metrics
    row per split, one events file per split, one checkpoint), rank 1
    logs nothing of the loop, the losses are finite, every rank launched
    K4 train, K1 and K2 and no K3, and ``--decode`` reads the checkpoint
    back (one process, 16 utterances, finite). (c) The checkpoint decoded
    in f32 by two processes (each batch's rows padded to even, a block a
    rank) against the one-process f32 decode: max abs <= DECODE_TOL_F32,
    every rank on K4's decode mode. Each rank's launches are counted (set
    to 0 just before its CLI run, read just after)."""
    import torch
    from rsrgan_tpu_torch.cli import train as train_cli
    from rsrgan_tpu_torch.parallel import free_port
    data = [f"--data_dir={prepared['data_dir']}",
            f"--tr_list_file={prepared['train']}",
            f"--cv_list_file={prepared['cv']}"]
    save_dir = os.path.join(work, "parallel_cli")
    port = free_port()
    codes, outs, secs, counts = cli_processes(lambda i: [
        *GAN_RNN_RECIPE, "--min_epoches=1", "--max_epoches=1", *data,
        f"--save_dir={save_dir}", *coordinator_flags(port, i)], PAR_RANKS,
        counts_dir=os.path.join(work, "parallel_cli_counts"))
    if codes != [0] * PAR_RANKS:
        raise RuntimeError(f"two-process training exited {codes}: "
                           + outs[0][-2000:] + outs[-1][-2000:])
    rows = {}
    for split in ("train", "eval"):
        with open(os.path.join(save_dir, f"metrics_{split}.jsonl")) as f:
            rows[split] = [json.loads(line) for line in f]
    files = sorted(os.listdir(save_dir))
    events = {s: len(os.listdir(os.path.join(save_dir, s)))
              for s in ("train", "eval")}
    only_rank0 = (all(len(r) == 1 for r in rows.values())
                  and events == {"train": 1, "eval": 1}
                  and [f for f in files if f.endswith(".ckpt")]
                  == ["GAN_RNN-1.ckpt"]
                  and "Iteration" in outs[0]
                  and all("Iteration" not in o for o in outs[1:]))
    backend_line = next((ln for ln in outs[0].splitlines()
                         if ln.startswith("LOG: data-parallel world")), "")
    row = rows["train"][0]
    losses = {k: v for r in (row, rows["eval"][0]) for k, v in r.items()
              if k.endswith("loss")}

    def decode_argv(dst, *extra):
        return ["--decode", "--trainer=gan_rnn", "--g_type=res_lstm_l",
                f"--input_dim={P}", f"--output_dim={OUT}",
                "--decode_batch_size=16", f"--data_dir={prepared['data_dir']}",
                f"--test_list_file={prepared['cv']}", f"--save_dir={dst}",
                *extra]

    arks = {}
    for tag, extra in (("bf16", []), ("f32", ["--bf16=false"])):
        dst = os.path.join(work, f"parallel_decode_{tag}")
        shutil.copytree(save_dir, dst)
        rc = train_cli.main(decode_argv(dst, *extra))
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"decode of the two-process checkpoint "
                               f"returned {rc}")
        arks[tag] = read_ark(os.path.join(dst, "test", "feats.scp"))
    decode_ok = (len(arks["bf16"]) == 16
                 and all(m.shape[1] == OUT and np.isfinite(m).all()
                         for m in arks["bf16"].values()))
    dst = os.path.join(work, "parallel_decode_ranks")
    shutil.copytree(save_dir, dst)
    port = free_port()
    dcodes, douts, dsecs, dcounts = cli_processes(lambda i: [
        *decode_argv(dst, "--bf16=false"), *coordinator_flags(port, i)],
        PAR_RANKS, counts_dir=os.path.join(work, "parallel_decode_counts"))
    if dcodes != [0] * PAR_RANKS:
        raise RuntimeError(f"two-process decode exited {dcodes}: "
                           + douts[0][-2000:] + douts[-1][-2000:])
    ranks_ark = read_ark(os.path.join(dst, "test", "feats.scp"))
    want = arks["f32"]
    decode_err = (max(float(np.abs(ranks_ark[u] - m).max())
                      for u, m in want.items())
                  if list(ranks_ark) == list(want) else float("inf"))
    train_routes = all(c[k] > 0 for c in counts
                       for k in ("wavefront_fwd_train", "lstm_fwd",
                                 "lstm_bwd")) and all(
        c["lstm_bwd_acc"] == 0 for c in counts)
    decode_routes = all(c["wavefront_fwd"] > 0 and c["lstm_bwd"] == 0
                        for c in dcounts)
    totals = ("wavefront_fwd_train", "wavefront_fwd", "lstm_fwd", "lstm_bwd",
              "lstm_bwd_acc")
    return {"cli": {"flags": "recipes/run_gan_rnn.sh (--same_batch=false, "
                             "B=8 a rank), bf16, 1 epoch, 2 processes",
                    "exit_codes": codes, "seconds": secs,
                    "backend_line": backend_line,
                    "only_rank0_writes": only_rank0, "files": files,
                    "losses": losses, "steps": row["train_steps"],
                    "ms_per_step": 1e3 * row["train_secs"]
                    / row["train_steps"],
                    "train_frames_per_s": row["train_frames_per_sec"],
                    "launches_per_rank": [{k: c[k] for k in totals}
                                          for c in counts],
                    "by_shape_per_rank": [by_shape(c) for c in counts],
                    "routes_ok": train_routes, "decode_ok": decode_ok},
            "decode": {"exit_codes": dcodes, "seconds": dsecs,
                       "utterances": len(ranks_ark),
                       "max_abs_err_vs_one_process": decode_err,
                       "tol": DECODE_TOL_F32,
                       "launches_per_rank": [{k: c[k] for k in totals}
                                             for c in dcounts],
                       "by_shape_per_rank": [by_shape(c) for c in dcounts],
                       "routes_ok": decode_routes},
            "ok": (only_rank0 and " over gloo " in backend_line and decode_ok
                   and train_routes and decode_routes
                   and all(np.isfinite(v) for v in losses.values())
                   and decode_err <= DECODE_TOL_F32)}


# (e) Tensor parallelism (JAX's model axis: make_world(model_parallel=2),
# shard_state(tensor_parallel=True)) on the first card over gloo, the
# library's f32 flagship step on (a)'s 16-row batch: "e1" two ranks, data
# 1 x model 2, each on all 16 rows, against (a)'s one-process step; "e2"
# four ranks, data 2 x model 2 (JAX's 8-device (4, 2) test on one card),
# 8 rows a data rank, against (a)'s data-parallel rank 0. Each rank's
# launches (in total and by shape) must be those of the step it is held
# against; then one bf16 step on e1's ranks, whose losses must be finite
# on the same routes.
TP_WORLDS = {"e1": (2, 2), "e2": (4, 2)}   # (ranks, model_parallel)


def _tp_rank(rank: int, world: int, address: str, work: str,
             model_parallel: int) -> int:
    """One rank of (e): ``flagship_step`` with the state sharded over the
    model axis, timed; with ``model_parallel`` == world (data 1) also the
    bf16 step; rank 0 saves its gradients and params, every rank its
    launches, state bytes, times and layout."""
    import torch
    from rsrgan_tpu_torch.parallel import initialize, make_world, shutdown
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    initialize(address, world, rank, device)
    try:
        w = make_world(device, model_parallel)
        batch = np.load(os.path.join(os.path.dirname(work),
                                     "parallel_batch.npz"))
        args = (batch["x"], batch["y"], batch["lens"])
        out = flagship_step(*args, PAR_TIMED_STEPS, tensor_parallel=True)
        info = {k: out[k] for k in ("launches", "by_shape", "state_bytes",
                                    "sharded_leaves", "blocks_ok",
                                    "ms_per_step", "collective_share")}
        info.update(backend=w.backend, layout=[w.data_rank, w.data_size,
                                               w.model_rank, w.model])
        if rank == 0:
            torch.save({k: out[k] for k in ("grads", "params")},
                       os.path.join(work, "tp_rank0.pt"))
        if w.data_size == 1:
            del out
            torch.cuda.empty_cache()
            bf = flagship_step(*args, 0, tensor_parallel=True,
                               dtype=torch.bfloat16)
            info["bf16"] = {"metrics": bf["metrics"],
                            "launches": bf["launches"]}
        with open(os.path.join(work, f"tp_rank{rank}.json"), "w") as f:
            json.dump(info, f)
        return 0
    finally:
        shutdown()


def bit_equal(a: dict, b: dict) -> bool:
    """Every gradient of the 3 updates and every post-step param the
    same bits in two steps' results."""
    return (all(torch_equal(x[1], y[1]) for x, y in zip(a["grads"],
                                                         b["grads"]))
            and all(torch_equal(a["params"][n], b["params"][n])
                    for n in ("g", "d")))


def torch_equal(a: dict, b: dict) -> bool:
    import torch
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def parallel_tp(work: str, lib: dict, ref: dict, got: dict,
                card: str) -> dict:
    """(e) Each world of TP_WORLDS on the first card, against the step
    it mirrors: the 3 updates' gradients and G's and D's post-step params
    gated at GRAD_TOL (max |diff| / max |ref| per tensor), whether they
    are bit-equal, each rank's launches against the mirrored step's in
    total and by shape; each rank's bytes of EMA and moments (and the
    one-process state's), ms per step and share in collectives; on e1
    the bf16 step's losses finite on the same routes. Emits one line a
    world."""
    import torch
    from rsrgan_tpu_torch.parallel import launch
    out = {}
    want = {"e1": (ref, PAR_ONE_LAUNCHES, ref["by_shape"]),
            "e2": (got, PAR_RANK_LAUNCHES, lib["by_shape_per_rank"][0])}
    for tag, (ranks, m) in TP_WORLDS.items():
        d = os.path.join(work, "parallel", f"tp_{tag}")
        os.makedirs(d, exist_ok=True)
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        rc = launch(_tp_rank, ranks, args=(d, m), timeout=PROCESS_TIMEOUT)
        secs = time.monotonic() - t0
        if rc != 0:
            raise RuntimeError(f"a rank of the TP step {tag} exited {rc}")
        step = torch.load(os.path.join(d, "tp_rank0.pt"))
        per_rank = []
        for r in range(ranks):
            with open(os.path.join(d, f"tp_rank{r}.json")) as f:
                per_rank.append(json.load(f))
        base, launches, shapes = want[tag]
        names = ("d_step", "g_step_1", "g_step_2")
        grad_errs = {n: max(rel_errs(a[1], b[1]).values())
                     for n, a, b in zip(names, step["grads"], base["grads"])}
        post = {net: max(rel_errs(step["params"][net],
                                  base["params"][net]).values())
                for net in ("g", "d")}
        routes_ok = all(r["launches"] == launches and r["by_shape"] == shapes
                        for r in per_rank)
        bf16 = [r["bf16"] for r in per_rank if "bf16" in r]
        bf16_ok = (tag != "e1" or (
            len(bf16) == ranks
            and all(b["launches"] == launches
                    and all(np.isfinite(v) for v in b["metrics"].values())
                    for b in bf16)))
        res = {"phase": "parallel_tp", "world": tag, "ranks": ranks,
               "data": ranks // m, "model": m,
               "rows_per_data_rank": 16 // (ranks // m),
               "held_against": ("(a)'s one-process step at 16 rows"
                                if tag == "e1" else
                                "(a)'s data-parallel rank 0 (world 2)"),
               "grad_rel_err": grad_errs, "post_step_param_rel_err": post,
               "tol": GRAD_TOL, "bit_equal": bit_equal(step, base),
               "launches_per_rank": [r["launches"] for r in per_rank],
               "by_shape_per_rank": [r["by_shape"] for r in per_rank],
               "routes_ok": routes_ok,
               "layouts": [r["layout"] for r in per_rank],
               "backend": per_rank[0]["backend"],
               "sharded_leaves": per_rank[0]["sharded_leaves"],
               "state_bytes_per_rank": [r["state_bytes"] for r in per_rank],
               "state_bytes_one_process": ref["state_bytes"],
               "blocks_ok": all(r["blocks_ok"] for r in per_rank),
               "ms_per_step_ranks": [r["ms_per_step"] for r in per_rank],
               "collective_share_ranks": [r["collective_share"]
                                          for r in per_rank],
               "ms_per_step_one_process": ref["ms_per_step"],
               "bf16_losses": [b["metrics"] for b in bf16],
               "bf16_launches": [b["launches"] for b in bf16],
               "bf16_ok": bf16_ok, "launch_seconds": secs,
               "name, power.limit": card}
        res["ok"] = (len(grad_errs) == 3
                     and all(e <= GRAD_TOL for e in grad_errs.values())
                     and all(e <= GRAD_TOL for e in post.values())
                     and routes_ok and bf16_ok and res["blocks_ok"]
                     and res["backend"] == "gloo"
                     and res["sharded_leaves"] == {"g": 12, "d": 6})
        emit(res)
        out[tag] = res
    return out


def parallel_multihost(work: str) -> dict:
    """recipes/run_multihost.sh through ``tools.experiments
    --recipe=multihost``: the frame DNN as two processes sharing the
    first card over gloo, gated as (b): exit 0 on both, the PASSED line's
    checkpoint, only rank 0 writing (one metrics row an iteration, one
    events file a split), finite losses. The DNN runs no hand kernel."""
    from rsrgan_tpu_torch.tools import experiments
    args = experiments.build_parser().parse_args([
        "--recipe=multihost", f"--workdir={os.path.join(work, 'multihost')}",
        "--device=cuda"])
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = (saved or "0").split(",")[0]
    try:
        rc, res = experiments.run_recipe(args)
    finally:
        if saved is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES")
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved
    save_dir = res["save_dir"]
    rows = {}
    for split in ("train", "eval"):
        with open(os.path.join(save_dir, f"metrics_{split}.jsonl")) as f:
            rows[split] = [json.loads(ln) for ln in f if ln.strip()]
    events = {s: len(os.listdir(os.path.join(save_dir, s)))
              for s in ("train", "eval")}
    losses = [v for r in rows["train"] + rows["eval"] for k, v in r.items()
              if k.endswith("loss")]
    out = {"phase": "parallel_multihost", "rc": rc,
           "exit_codes": res["exit_codes"],
           "eval_records": res["eval_records"],
           "stage_seconds": res["stage_seconds"], "seconds": res["seconds"],
           "rows": {s: len(r) for s, r in rows.items()}, "events": events,
           "last_eval_g_loss": rows["eval"][-1]["g_loss"],
           "train_frames_per_s": [r["train_frames_per_sec"]
                                  for r in rows["train"]]}
    out["ok"] = (rc == 0 and res["exit_codes"] == [0, 0]
                 and res["eval_records"] == len(rows["eval"])
                 == len(rows["train"]) >= 1
                 and events == {"train": 1, "eval": 1}
                 and all(np.isfinite(v) for v in losses))
    emit(out)
    return out


def mps_status() -> dict:
    """Whether the card runs the MPS server (two ranks' 132-block
    cooperative grids could not then be resident at once): the compute
    mode nvidia-smi reports and whether an MPS control pipe exists."""
    try:
        q = subprocess.run(["nvidia-smi", "-q"], capture_output=True,
                           text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"error": str(e)}
    mode = next((ln.split(":", 1)[1].strip() for ln in q.splitlines()
                 if ln.strip().startswith("Compute Mode")), None)
    pipe = os.environ.get("CUDA_MPS_PIPE_DIRECTORY", "/tmp/nvidia-mps")
    return {"compute_mode": mode,
            "mps_pipe": os.path.exists(os.path.join(pipe, "control")),
            "mps_in_query": "MPS" in q}


def parallel_shapes(runs: dict) -> dict:
    """"wrapper shape_key" -> {run: [each rank's launches there]} for
    every shape that a rank of ``runs`` (run -> each rank's counts by
    shape) launched a kernel at, in a fixed order."""
    keys = sorted({(name, key) for ranks in runs.values() for c in ranks
                   for name in PAR_KERNELS for key in c[f"{name}_by_shape"]})
    return {f"{name} {key}": {run: [c[f"{name}_by_shape"].get(key, 0)
                                    for c in ranks]
                              for run, ranks in runs.items()}
            for name, key in keys}


def phase_parallel(work: str, prepared: dict) -> dict:
    """Data and tensor parallelism on the card: (a) the library step on
    two ranks sharing the first card over gloo against the one-process
    step; (b) the recipe's two-process CLI epoch and the decode of its
    checkpoint; (c) the two-process decode against the one-process
    decode; (e) tensor parallelism, data 1 x model 2 and data 2 x model
    2 (``parallel_tp``), and run_multihost.sh's two processes
    (``parallel_multihost``); (d) with two or more cards, the library
    step a rank a card over nccl and a --num_gpu=2 epoch, else a line
    saying it was not run. Then every kernel at each shape a rank
    launched it at in those runs, against its twin in f32 and bf16 (T
    the library batch's t_pad, rows of rank 0's lengths). Times: ranks
    time-slicing one card, not scaling."""
    import torch
    card = card_name_and_limit()
    mps = mps_status()
    lib, ref, got = parallel_library_step(prepared["train"], work,
                                          PAR_RANKS, per_card=False)
    cli = parallel_cli(prepared, work)
    tp = parallel_tp(work, lib, ref, got, card)
    multihost = parallel_multihost(work)
    out = {"phase": "parallel", "mps": mps, "library_step": lib, **cli,
           "tensor_parallel": tp, "multihost": multihost,
           "name, power.limit": card}
    runs = {"library_step": lib["by_shape_per_rank"],
            "cli_epoch": cli["cli"]["by_shape_per_rank"],
            "cli_decode": cli["decode"]["by_shape_per_rank"],
            **{f"tp_{t}": tp[t]["by_shape_per_rank"] for t in TP_WORLDS}}
    cards = torch.cuda.device_count()
    multi_ok = True
    if cards >= 2:
        nccl = parallel_library_step(prepared["train"], work, 2,
                                     per_card=True)[0]
        runs["library_step_nccl"] = nccl["by_shape_per_rank"]
        codes, outs, secs, _ = cli_processes(lambda i: [
            *GAN_RNN_RECIPE, "--min_epoches=1", "--max_epoches=1",
            "--num_gpu=2", f"--data_dir={prepared['data_dir']}",
            f"--tr_list_file={prepared['train']}",
            f"--cv_list_file={prepared['cv']}",
            f"--save_dir={os.path.join(work, 'parallel_num_gpu')}"], 1,
            shared_card=False)
        multi_ok = (nccl["ok"] and nccl["backend"] == "nccl"
                    and codes == [0] and " over nccl " in outs[0])
        out["multi_card"] = {"library_step": nccl, "num_gpu_2_rc": codes[0],
                             "num_gpu_2_seconds": secs, "ok": multi_ok}
    else:
        emit({"phase": "parallel_multi_card", "run": False,
              "why": f"torch.cuda.device_count() is {cards}: NCCL needs "
                     "a card a rank, so the NCCL step and --num_gpu=2 "
                     "were not run (this line is not a pass)"})
    out["launches_by_shape"] = parallel_shapes(runs)
    t0 = time.monotonic()
    kernels = {d: [chain_kernel(*shape.split(" "), d, T_=lib["t_pad"],
                                lengths=lib["rank0_lengths"],
                                phase="parallel_kernels")
                   for shape in out["launches_by_shape"]]
               for d in ("float32", "bfloat16")}
    out["kernel_check_seconds"] = time.monotonic() - t0
    out["timing_note"] = ("two ranks time-slicing one card (gloo), not "
                          "scaling; ms per f32 library step after the "
                          "checked one; the collectives' share is the wall "
                          "time inside them, a synchronize of this rank's "
                          "stream before each, so the wait for the other "
                          "rank to reach it included")
    out["ok"] = (lib["ok"] and lib["backend"] == "gloo" and cli["ok"]
                 and all(tp[t]["ok"] for t in TP_WORLDS)
                 and multihost["ok"]
                 and multi_ok and bool(out["launches_by_shape"])
                 and all(r["ok"] for rs in kernels.values() for r in rs))
    emit(out)
    out["kernels"] = kernels
    return out


# The feed phase's corpus: about 2 GB of f32 tables (257 + 40 columns),
# utterances of 150-600 frames; the reference's training set (~100 h) is
# ~36 M frames, which the upload rate is extrapolated to.
FEED_FRAMES = 1_700_000
REFERENCE_FRAMES = 36_000_000
# Rotation: a slice of the corpus cut into at least 3 shards by the
# budget, two passes with prefetch; each residency's gathers queue behind
# a device sleep, so an upload that did not wait for them would overwrite
# rows they still have to read.
ROTATION_UTTS = 1200
ROTATION_SLEEP_CYCLES = 200_000_000


def write_feed_corpus(data_dir: str, seed: int) -> tuple:
    """A seeded store of about FEED_FRAMES frames, plus a 16-utterance cv
    store; their list files."""
    from rsrgan_tpu_torch.data import StoreWriter
    rng = np.random.default_rng(seed)
    lists, frames = {}, 0
    for name in ("feed_tr", "feed_cv"):
        path = os.path.join(data_dir, f"{name}.rtu")
        with StoreWriter(path) as w:
            i = 0
            while (frames < FEED_FRAMES if name == "feed_tr" else i < 16):
                n = int(rng.integers(150, 601))
                w.add(f"{name}{i:05d}",
                      rng.standard_normal((n, P), dtype=np.float32),
                      rng.standard_normal((n, OUT), dtype=np.float32))
                frames += n if name == "feed_tr" else 0
                i += 1
        lists[name] = os.path.join(data_dir, f"{name}.list")
        with open(lists[name], "w") as f:
            f.write(path + "\n")
    return lists["feed_tr"], lists["feed_cv"]


def host_batch_ms(batcher, indices, device, reps: int) -> tuple:
    """The host feed's cost of one batch: SequenceBatcher._make_batch and
    the pageable copies of its three arrays, to a synchronise (ms, the
    last batch)."""
    import torch
    times = []
    for _ in range(reps):
        t0 = time.monotonic()
        batch = batcher._make_batch(indices)
        on_dev = [torch.from_numpy(a).to(device)
                  for a in (batch.inputs, batch.labels, batch.lengths)]
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    return float(np.median(times)), on_dev


def rotation_check(store, cv_store, device) -> dict:
    """The CLI's rotating feed on ROTATION_UTTS utterances: a budget in
    RSRGAN_FEED_HBM_BUDGET that cuts them into >= 3 shards, decided by
    decide_device_feed as the CLI decides it, prefetch on, block 1, two
    passes; every gathered batch of every residency against the host
    batch of that shard's StoreView batcher, bit for bit."""
    import torch
    from rsrgan_tpu_torch.cli import train as train_cli
    from rsrgan_tpu_torch.data import SequenceBatcher, StoreView
    from rsrgan_tpu_torch.data.device_feed import (RotatingDeviceFeed,
                                                   table_bytes)
    from rsrgan_tpu_torch.ops.gather import assemble_sequence_batch
    view = StoreView(store, np.arange(ROTATION_UTTS))
    cv_bytes = table_bytes(cv_store, 4)
    # two buffers of a quarter of the slice each: four or five shards
    budget = cv_bytes + table_bytes(view, 4) // 2
    args = train_cli.build_parser().parse_args(
        ["--device_feed=on", "--device_feed_dtype=float32",
         "--feed_prefetch=true"])
    old = os.environ.get("RSRGAN_FEED_HBM_BUDGET")
    os.environ["RSRGAN_FEED_HBM_BUDGET"] = str(budget)
    try:
        plan = train_cli.decide_device_feed(args, view, cv_store, device)
    finally:
        if old is None:
            del os.environ["RSRGAN_FEED_HBM_BUDGET"]
        else:
            os.environ["RSRGAN_FEED_HBM_BUDGET"] = old
    feed = RotatingDeviceFeed(view, plan.dtype, plan.budget - cv_bytes,
                              device, seed=5, prefetch=True)
    def make_batcher(shard):
        # the CLI's rule: ragged batches where a shard has no full one
        b = SequenceBatcher(shard, B, seed=5)
        return (b if b.num_batches() else
                SequenceBatcher(shard, B, seed=5, drop_remainder=False))

    batchers = [make_batcher(StoreView(view, s)) for s in feed.shards]
    visits = feed.schedule(2, 1, seed=5)
    gathered = []
    t0 = time.monotonic()
    for r, (k, _) in enumerate(visits):
        feed.ensure_resident(k)
        if r + 1 < len(visits):
            feed.start_prefetch(visits[r + 1][0])
        torch.cuda._sleep(ROTATION_SLEEP_CYCLES)
        for indices in batchers[k].iter_index_batches():
            st, le = feed.plan(indices)
            x, y = assemble_sequence_batch(
                feed.inputs_tbl, feed.labels_tbl,
                torch.from_numpy(st).to(device),
                torch.from_numpy(le).to(device),
                train_cli.plan_key(le, batchers[k].num_buckets)[0], 0, 0)
            gathered.append((k, indices, x, y))
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    mismatched = 0
    for k, indices, x, y in gathered:
        host = batchers[k]._make_batch(indices)
        mismatched += int(not (
            np.array_equal(x.cpu().numpy(), host.inputs)
            and np.array_equal(y.cpu().numpy(), host.labels)))
    return {"shards": feed.num_shards, "residencies": len(visits),
            "rotate": plan.rotate, "budget_bytes": budget,
            "batches": len(gathered), "mismatched": mismatched,
            "uploads": feed.uploads, "upload_secs": feed.upload_secs,
            "seconds": secs,
            "ok": (plan.rotate and feed.num_shards >= 3 and mismatched == 0
                   and len({k for k, *_ in gathered}) == feed.num_shards)}


def phase_feed(work: str) -> dict:
    """The device feed at the scale of a real corpus: upload rates of f32
    and bf16 tables (and the reference corpus's upload, extrapolated), the
    gather of one batch at B=16 and 32, T_pad=600, against the host
    batch, and the rotating feed bit-equal to the host batches."""
    import torch
    from rsrgan_tpu_torch.cli import train as train_cli
    from rsrgan_tpu_torch.data import (SequenceBatcher, UtteranceStore,
                                       read_list_file)
    from rsrgan_tpu_torch.data.device_feed import DeviceFeed, table_bytes
    from rsrgan_tpu_torch.ops.gather import assemble_sequence_batch
    device = torch.device("cuda")
    data_dir = os.path.join(work, "feed_data")
    os.makedirs(data_dir)
    t0 = time.monotonic()
    tr_list, cv_list = write_feed_corpus(data_dir, 17)
    store = UtteranceStore(read_list_file(tr_list))
    cv_store = UtteranceStore(read_list_file(cv_list))
    write_secs = time.monotonic() - t0
    frames = int(store.lengths.sum())
    host_bytes = table_bytes(store, 4)   # what crosses the link, f32 rows

    uploads = {}
    feed = None
    for dtype_name in ("bfloat16", "float32"):
        secs = []
        for _ in range(2):
            feed = None
            torch.cuda.empty_cache()
            t1 = time.monotonic()
            feed = DeviceFeed(store, getattr(torch, dtype_name), device)
            secs.append(time.monotonic() - t1)
        uploads[dtype_name] = {
            "seconds": secs, "table_bytes": feed.num_bytes,
            "host_gb_per_s": [host_bytes / s / 1e9 for s in secs],
            "extrapolated_reference_upload_s": (
                REFERENCE_FRAMES / frames * min(secs))}
    # feed holds the f32 tables now
    batcher = SequenceBatcher(store, B, seed=0)
    # lengths 551-599 pad to 600 (600 itself opens the next bucket)
    long_ix = [int(i) for i in np.flatnonzero(
        (store.lengths > 550) & (store.lengths < 600))]
    gather, equal = {}, len(long_ix) >= 2 * B
    for rows in (B, 2 * B):
        indices = long_ix[:rows]
        st, le = feed.plan(indices)
        st_d, le_d = (torch.from_numpy(a).to(device) for a in (st, le))
        run = lambda: assemble_sequence_batch(  # noqa: E731
            feed.inputs_tbl, feed.labels_tbl, st_d, le_d, 600, 0, 0)
        x, y = run()
        host_ms, (hx, hy, _) = host_batch_ms(batcher, indices, device, 5)
        equal = equal and torch.equal(x, hx) and torch.equal(y, hy)
        gather[rows] = {"gather_us": 1e3 * cuda_time_ms(run, 50),
                        "host_batch_ms": host_ms, "T_pad": 600,
                        "bytes_out": (x.numel() + y.numel()) * 4}
    feed = None
    torch.cuda.empty_cache()
    rotation = rotation_check(store, cv_store, device)
    secs = time.monotonic() - t0
    shutil.rmtree(data_dir)
    out = {"phase": "feed", "frames": frames, "utterances": len(store),
           "f32_table_bytes": host_bytes, "corpus_write_secs": write_secs,
           "upload": uploads, "gather": gather, "gather_equals_host": equal,
           "rotation": rotation, "seconds": secs,
           "default_budget_bytes": train_cli.default_feed_budget(device),
           "name, power.limit": card_name_and_limit(),
           "ok": equal and rotation["ok"]}
    emit(out)
    return out


def read_ark(scp_path: str) -> dict:
    from rsrgan_tpu_torch.data import ScpReader
    return dict(iter(ScpReader(scp_path)))


def decode_inputs(work: str) -> tuple:
    """The decode phase's seeded 32-utterance test store (150-600 frames,
    P wide) and train_cmvn.npz under ``work``/data, written once: (data
    dir, test list, lengths)."""
    from rsrgan_tpu_torch.data import StoreWriter
    rng = np.random.default_rng(3)
    data_dir = os.path.join(work, "data")
    test_list = os.path.join(data_dir, "test.list")
    lengths = rng.integers(150, 601, size=32)
    if os.path.isfile(test_list):
        return data_dir, test_list, lengths
    os.makedirs(data_dir)
    with StoreWriter(os.path.join(data_dir, "test.rtu")) as store:
        for i, n in enumerate(lengths):
            store.add(f"utt{i:04d}",
                      rng.normal(size=(int(n), P)).astype(np.float32))
    with open(test_list, "w") as f:
        f.write(os.path.join(data_dir, "test.rtu") + "\n")
    np.savez(os.path.join(data_dir, "train_cmvn.npz"),
             mean_inputs=rng.normal(size=P), stddev_inputs=np.ones(P),
             mean_labels=rng.normal(size=OUT),
             stddev_labels=rng.uniform(0.5, 2.0, size=OUT))
    return data_dir, test_list, lengths


def g_checkpoint(save_dir: str, tree: dict, out: int) -> None:
    """A checkpoint of G's tree alone (params and EMA) with its
    .meta.json, as ``cli.train --decode`` and ``cli.serve`` read it."""
    from rsrgan_tpu_torch.training import save_checkpoint
    save_checkpoint(save_dir, "GAN_RNN",
                    {"g": {"params": tree, "ema": tree},
                     "step": np.zeros((), np.int32)}, 1,
                    meta={"trainer": "gan_rnn", "g_type": "res_lstm_l",
                          "input_dim": P, "output_dim": out,
                          "left_context": 0, "right_context": 0})


def decode_phase_checkpoint(work: str) -> tuple:
    """The decode phase's seeded res_lstm_l checkpoint under
    ``work``/ckpt, written once: (its directory, G's tree)."""
    tree = generator_tree(4)
    ckpt_dir = os.path.join(work, "ckpt")
    if not os.path.isdir(ckpt_dir):
        g_checkpoint(ckpt_dir, tree, OUT)
    return ckpt_dir, tree


def phase_decode(work: str) -> dict:

    import torch
    from rsrgan_tpu_torch.cli import train as train_cli
    from rsrgan_tpu_torch.ops.wavefront import lstm_wavefront_fwd

    data_dir, test_list, lengths = decode_inputs(work)
    ckpt_dir, _ = decode_phase_checkpoint(work)

    def decode(tag, *flags):
        save_dir = os.path.join(work, tag)
        shutil.copytree(ckpt_dir, save_dir)
        t0 = time.monotonic()
        rc = train_cli.main(["--decode", "--trainer=gan_rnn",
                             "--g_type=res_lstm_l", "--decode_batch_size=16",
                             f"--input_dim={P}", f"--output_dim={OUT}",
                             f"--data_dir={data_dir}",
                             f"--test_list_file={test_list}",
                             f"--save_dir={save_dir}", *flags])
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        if rc != 0:
            raise RuntimeError(f"decode {tag} returned {rc}")
        return read_ark(os.path.join(save_dir, "test", "feats.scp")), secs

    f32_kernel, _ = decode("f32_kernel", "--bf16=false")
    f32_scan, scan_secs = decode("f32_scan", "--bf16=false",
                                 "--lstm_impl=scan")
    lstm_wavefront_fwd.launches = 0
    main_ark, main_secs = decode("main")  # default flags: bf16, kernel
    launches = lstm_wavefront_fwd.launches

    frames = int(lengths.sum())
    shapes_ok = all(main_ark[f"utt{i:04d}"].shape == (int(n), OUT)
                    for i, n in enumerate(lengths))
    finite = all(np.isfinite(m).all() for m in main_ark.values())
    diff_f32 = max(float(np.abs(f32_kernel[u] - f32_scan[u]).max())
                   for u in f32_scan)
    diff_bf16 = max(float(np.abs(main_ark[u] - f32_scan[u]).max())
                    for u in f32_scan)
    out = {"phase": "decode", "utterances": len(main_ark), "frames": frames,
           "main_seconds": main_secs, "frames_per_s": frames / main_secs,
           "scan_f32_seconds": scan_secs, "launches": launches,
           "shapes_ok": shapes_ok, "finite": finite,
           "f32_kernel_vs_scan_max_abs": diff_f32, "tol": DECODE_TOL_F32,
           "bf16_kernel_vs_f32_scan_max_abs": diff_bf16,
           "ok": (launches > 0 and shapes_ok and finite
                  and diff_f32 <= DECODE_TOL_F32)}
    emit(out)
    return out


# The chain phase: the recipes' wav -> ark and wav -> wav chains through
# the port's CLIs (rsrgan_tpu_torch.tools.e2e_chain), at the recipes' size.
CHAIN_UTTS, CHAIN_EPOCHS = 96, 12
# The chains' kernel checks: every shape the chains launched, at a padded
# length at the top of theirs (their utterances are 1.2-3.0 s: 118-298
# frames), every row ragged.
CHAIN_T = 300
CHAIN_LENGTHS = [300, 251, 207, 163, 288, 240, 199, 150]
# The float32 feature contract of tests/test_feature_oracle.py: LPS power
# relative to the frame's peak, the log domain on bins above 1e-6 of it,
# the energy slot; MFCC by wave (max, median). dsp_golden.npz's MFCC is
# the JAX front-end's own float32 output on a tone spanning eleven
# decades, 2e-2 from float64 (tests/test_torch_features.py): 5e-2 there.
LPS_POWER_TOL, LPS_LOG_TOL, LPS_BIN0_TOL = 1e-5, 5e-4, 1e-5
MFCC_TOL = {"speech": (2e-2, 1e-4), "noise": (1e-3, 1e-4),
            "tone": (2e-2, 1e-4), "golden": (5e-2, None)}


def lps_parity(got, want) -> dict:
    p_g, p_w = np.exp(got[:, 1:]), np.exp(want[:, 1:])
    scale = p_w.max(axis=1, keepdims=True)
    mask = p_w > 1e-6 * scale
    out = {"bin0": float(np.abs(got[:, 0] - want[:, 0]).max()),
           "power_rel": float((np.abs(p_g - p_w) / scale).max()),
           "log_masked": float(np.abs(got[:, 1:]
                                      - want[:, 1:])[mask].max()),
           "all_bins_max": float(np.abs(got - want).max())}
    out["ok"] = (got.shape == want.shape and out["bin0"] <= LPS_BIN0_TOL
                 and out["power_rel"] <= LPS_POWER_TOL
                 and out["log_masked"] <= LPS_LOG_TOL)
    return out


def mfcc_parity(got, want, kind) -> dict:
    diff = np.abs(got - want)
    top, med = MFCC_TOL[kind]
    out = {"max": float(diff.max()), "median": float(np.median(diff))}
    out["ok"] = (got.shape == want.shape and out["max"] <= top
                 and (med is None or out["median"] <= med))
    return out


def chain_features(work: str) -> dict:
    """Features on the card: the fixtures' waves through the extraction
    CLI's engine (``BatchedExtractor``, one stack) on the card, gated on
    the fixtures and held against the same stack on the CPU; then the CLI
    itself on a 40-utterance corpus at --batch_size=16 and 1 with dither,
    bit-equal, TF32 turned on before each run and found off after."""
    import scipy
    import torch
    from rsrgan_tpu_torch.cli import extract
    from rsrgan_tpu_torch.features import FrameOptions
    from rsrgan_tpu_torch.sim import make_sim_assets

    emit({"phase": "chain_scipy", "import scipy": scipy.__version__})
    oracle = np.load(os.path.join(HERE, "tests/fixtures/oracle_feats.npz"))
    golden = np.load(os.path.join(HERE, "tests/fixtures/dsp_golden.npz"))
    waves = {k: oracle[f"wave_{k}"] for k in ("speech", "noise", "tone")}
    waves["golden"] = golden["wave"]
    want = {(k, "spectrogram"): oracle[f"lps_{k}"] for k in MFCC_TOL
            if k != "golden"}
    want.update({(k, "mfcc"): oracle[f"mfcc_{k}"] for k in MFCC_TOL
                 if k != "golden"})
    want["golden", "spectrogram"] = golden["lps"]
    want["golden", "mfcc"] = golden["mfcc"]

    def extract_all(feat, device):
        ex = extract.BatchedExtractor(feat, FrameOptions(dither=0.0), False,
                                      len(waves), torch.device(device))
        got = {}
        for i, w in enumerate(waves.values()):
            got.update(ex.add(i, w, i))
        got.update(ex.flush_all())
        return {k: got[i] for i, k in enumerate(waves)}

    out = {"phase": "chain_features", "fixtures": {}, "card_vs_cpu": {}}
    oks = []
    for feat in ("spectrogram", "mfcc"):
        card, cpu = extract_all(feat, "cuda"), extract_all(feat, "cpu")
        for k in waves:
            r = (lps_parity(card[k], want[k, feat]) if feat == "spectrogram"
                 else mfcc_parity(card[k], want[k, feat], k))
            out["fixtures"][f"{feat}/{k}"] = r
            oks.append(r["ok"])
        out["card_vs_cpu"][feat] = max(float(np.abs(card[k] - cpu[k]).max())
                                       for k in waves)

    wav_scp, _, _ = make_sim_assets(os.path.join(work, "feat_assets"),
                                    num_utts=40, min_dur_s=1.2,
                                    max_dur_s=3.0, seed=11)
    out["batched_vs_unbatched_bit_equal"] = {}
    out["tf32_off_after"] = True
    for feat in ("spectrogram", "mfcc"):
        arks = []
        for batch in (16, 1):
            d = os.path.join(work, f"feat_{feat}_{batch}")
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            t0 = time.monotonic()
            if extract.main([f"--wav_scp={wav_scp}", f"--feat_type={feat}",
                             f"--output_dir={d}", "--name=feats",
                             f"--batch_size={batch}",
                             "--device=cuda"]) != 0:
                raise RuntimeError(f"extract {feat} B={batch} failed")
            out[f"extract_{feat}_b{batch}_seconds"] = time.monotonic() - t0
            out["tf32_off_after"] &= not (
                torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)
            arks.append(read_ark(os.path.join(d, "feats.scp")))
        out["batched_vs_unbatched_bit_equal"][feat] = (
            list(arks[0]) == list(arks[1])
            and all(np.array_equal(arks[0][u], arks[1][u]) for u in arks[0]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["ok"] = (all(oks) and out["tf32_off_after"]
                 and all(out["batched_vs_unbatched_bit_equal"].values()))
    emit(out)
    return out


def chain_counters() -> dict:
    """counter_table() and the other three wrappers' counts by shape
    (``shape_key``: the sizes that choose a kernel's plan)."""
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    from rsrgan_tpu_torch.ops import wavefront as wf
    return {**counter_table(), **{
        f"{name}_by_shape": (fn, "launches_by_shape") for name, fn in (
            ("wavefront_fwd_train", wf.lstm_wavefront_fwd_train),
            ("wavefront_fwd", wf.lstm_wavefront_fwd),
            ("lstm_bwd", ls.lstm_bwd), ("lstm_bwd_acc", ls.lstm_bwd_acc))}}


def chain_kernel(kernel: str, key: str, dtype_name: str, T_: int = CHAIN_T,
                 lengths=CHAIN_LENGTHS, phase: str = "chain_kernels") -> dict:
    """One kernel at one shape that a run launched (``T_`` steps, rows of
    ``lengths`` repeated), every stream against its twin at the kernel
    phases' tolerances, on seeded inputs: K4 in train or decode mode; K1;
    K2 and K3 on the forward twin's streams (K3 on the route
    ``bwd_acc_route`` gives the shape)."""
    import torch
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    from rsrgan_tpu_torch.ops import wavefront as wf
    cdt = getattr(torch, dtype_name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sh = parse_shape(key)
    U_, P_, B_ = sh["U"], sh["P"], sh["B"]
    lens = (list(lengths) * (1 + B_ // len(lengths)))[:B_]
    seed = sum(map(ord, kernel + key))
    extra = {"phase": phase, "shape": key, "T": T_}
    streams4 = ("taps", "c_hist", "h_hist", "acts")
    if kernel.startswith("wavefront"):
        L_, residual, train = sh["L"], bool(sh["residual"]), "train" in kernel
        args = kernel_inputs(seed, L_, U_, P_, B_, T_, lens, cdt, "cuda")
        extra.update(**resident_grid(wf.resident_plan(B_, L_, U_, P_, cdt,
                                                      sms)),
                     **wavefront_bound(L_, U_, P_, B_, T_, lens,
                                       dtype_name, train=train,
                                       residual=residual))
        if train:
            return timed(kernel, dtype_name,
                         lambda: wf.lstm_wavefront_fwd_train(
                             *args, residual=residual),
                         lambda: wf.lstm_wavefront_fwd_reference(
                             *args, residual=residual, save_acts=True),
                         streams4, **extra)
        return timed(kernel, dtype_name,
                     lambda: (wf.lstm_wavefront_fwd(*args,
                                                    residual=residual),),
                     lambda: (wf.lstm_wavefront_fwd_reference(
                         *args, residual=residual),),
                     ("top_tap",), **extra)
    rng = np.random.default_rng(seed)
    prm = layer_params(rng, P_, U_, P_, cdt, "cuda")
    x = torch.from_numpy(
        rng.normal(size=(T_, B_, P_)).astype(np.float32)).cuda()
    xw = (x.to(cdt).float() @ prm["w_x"].to(cdt).float()).to(cdt)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    k1_args = (xw, lens_t, prm["w_h"], prm["proj"], prm["bias"], prm["wi"],
               prm["wf"], prm["wo"])
    if kernel == "lstm_fwd":
        grid = k1_grid(B_, U_, P_, cdt, sms)
        return timed(kernel, dtype_name, lambda: ls.lstm_fwd(*k1_args),
                     lambda: ls.lstm_fwd_reference(*k1_args), streams4,
                     check=k1_route_check(grid["design"], 6),
                     **extra, **grid,
                     **k1_bound(U_, P_, B_, T_, lens, dtype_name))
    _, c_h, h_h, acts = ls.lstm_fwd_reference(*k1_args)
    dout = torch.from_numpy(
        rng.normal(size=(T_, B_, P_)).astype(np.float32)).cuda()
    k2_args = (acts, lens_t, dout, c_h, prm["w_h"], prm["proj"], prm["wi"],
               prm["wf"], prm["wo"])
    if kernel == "lstm_bwd_acc":
        k3_args = k2_args[:4] + (h_h,) + k2_args[4:]
        route = ls.bwd_acc_route(B_, U_, P_, cdt, sms)
        grid = (rowgroup_grid(ls.rowgroup_bwd_plan(B_, U_, P_, cdt, sms))
                if route == "rowgroup" else resident_grid(ls.resident_plan(
                    B_, U_, P_, cdt, sms, acc=True))
                if route == "resident" else {})
        return timed(kernel, dtype_name, lambda: ls.lstm_bwd_acc(*k3_args),
                     lambda: ls.lstm_bwd_acc_reference(*k3_args), K3_GRADS,
                     route=route, **extra, **grid,
                     **bwd_bound(U_, P_, B_, T_, lens, dtype_name,
                                 acc=True))
    return timed(kernel, dtype_name, lambda: ls.lstm_bwd(*k2_args),
                 lambda: ls.lstm_bwd_reference(*k2_args), ("dxw", "m", "dh"),
                 **extra,
                 **resident_grid(ls.resident_plan(B_, U_, P_, cdt, sms)),
                 **bwd_bound(U_, P_, B_, T_, lens, dtype_name,
                             acc=False))


def chain_shapes(runs: dict) -> list:
    """(wrapper, shape_key) of every launch the chains' train and decode
    stages counted, in a fixed order."""
    return sorted({(name, key) for r in runs.values()
                   for stage in r["launches"].values()
                   for name in ("wavefront_fwd_train", "wavefront_fwd",
                                "lstm_fwd", "lstm_bwd")
                   for key in stage[f"{name}_by_shape"]})


def chain_run(work: str, target: str, counters: dict) -> dict:
    """One recipe chain through e2e_chain.run_chain; every launch count
    set to 0 just before its train and its decode stage and read just
    after, in total and by shape. At the recipes' --batch_size=4 every
    LSTM backward has 4 (G) or 8 (D) rows, below ACC_BWD_MIN_BATCH, so
    each runs on K2 and K3 never launches: its count must be 0."""
    import contextlib

    import torch
    from rsrgan_tpu_torch.tools import e2e_chain
    launches = {}

    @contextlib.contextmanager
    def counted(stage):
        if stage in ("train", "decode"):
            reset_counts(counters)
        yield
        if stage in ("train", "decode"):
            torch.cuda.synchronize()
            launches[stage] = read_counts(counters)

    res = e2e_chain.run_chain(target, os.path.join(work, f"chain_{target}"),
                              CHAIN_EPOCHS, CHAIN_UTTS, 12, "cuda",
                              stage_context=counted)
    tr, de = launches["train"], launches["decode"]
    routes = (all(tr[k] > 0 for k in ("wavefront_fwd_train", "lstm_fwd",
                                      "lstm_bwd"))
              and tr["lstm_bwd_acc"] == 0
              and de["wavefront_fwd"] > 0
              and de["wavefront_fwd_train"] == de["lstm_bwd"] == 0)
    keep = ("wavefront_fwd_train", "wavefront_fwd", "lstm_fwd",
            "lstm_bwd", "lstm_bwd_acc", "wavefront_fwd_train_by_shape",
            "wavefront_fwd_by_shape", "lstm_fwd_by_shape",
            "lstm_bwd_by_shape")
    out = {"phase": f"chain_{target}", **res,
           "launches": {s: {k: launches[s][k] for k in keep}
                        for s in ("train", "decode")},
           "routes_ok": routes}
    out["ok"] = bool(res["passed"] and routes)
    emit(out)
    return out


def phase_chain(work: str) -> dict:
    """Features on the card, then the LPS chain and the MFCC chain, then
    each kernel at every shape the chains launched it at, against its
    twin in f32 and bf16."""
    t0 = time.monotonic()
    counters = chain_counters()
    feats = chain_features(work)
    runs = {t: chain_run(work, t, counters) for t in ("lps", "mfcc")}
    t1 = time.monotonic()
    kernels = {d: [chain_kernel(name, key, d)
                   for name, key in chain_shapes(runs)]
               for d in ("float32", "bfloat16")}
    out = {"phase": "chain", "seconds": time.monotonic() - t0,
           "kernel_check_seconds": time.monotonic() - t1,
           "launches": {t: r["launches"] for t, r in runs.items()},
           "shapes_checked": [f"{n} {k}" for n, k in chain_shapes(runs)],
           "ok": (feats["ok"] and all(r["ok"] for r in runs.values())
                  and all(r["ok"] for rs in kernels.values() for r in rs))}
    emit(out)
    out["kernels"] = kernels
    return out


# The serve phase: res_lstm_l at full width through the port's streaming
# front-end (cli/serve.py; serving/), which runs the eager cell and no
# hand kernel. Feature mode from the decode phase's store, wav mode from
# seeded noisy waves through an LPS->LPS checkpoint.
SERVE_CHUNK = 50
SERVE_LONG_CHUNK = 640          # longer than every test utterance (<= 600)
SERVE_TIMED_CHUNKS = 200       # B=1 chunks timed
SERVE_POOL = 8
SERVE_POOL_STEPS = 50          # B=SERVE_POOL steps timed
SERVE_WAVS = 16
# pooled (B=8) against single (B=1) streams: the products' last bits
# differ with the batch; max |diff| / peak of the float waves
SERVE_POOL_TOL = 1e-5
# streamed against the offline chain (f32 --decode, then resynthesize):
# tests/test_wav_stream.py's gate
SERVE_SNR_DB = 35.0
# wav mode's label CMVN (the waves' own LPS mean, unit stddev) is shifted
# so that the first wave's enhanced peak is this; the written 16-bit
# waves must then stay below half of the range, so that nothing is clipped
SERVE_WAV_PEAK = 4000.0
SERVE_WAV_PEAK_MAX = 16384.0


def run_cli(main, argv) -> tuple:
    """``main(argv)`` in this process with TF32 turned on before it (the
    CLI must turn it off), its stdout captured: (seconds, stdout lines,
    TF32 off after)."""
    import contextlib
    import io

    import torch
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    off = not (torch.backends.cuda.matmul.allow_tf32
               or torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if rc != 0:
        raise RuntimeError(f"{main.__module__} {argv} returned {rc}")
    return secs, buf.getvalue().splitlines(), off


def hand_launches(counts: dict) -> int:
    """Every launch of every LSTM hand kernel in a read_counts() result
    (cli_epoch's ``optim``, the optimizer's, apart)."""
    return sum(sum(v.values()) if isinstance(v, dict) else v
               for k, v in counts.items()
               if k != "optim"
               and not k.endswith(("_by_shape", "_resident", "_streaming")))


def chunk_timing(enh, x: np.ndarray, rows: int, timed: int,
                 counters: dict) -> dict:
    """ms per streamed chunk of SERVE_CHUNK frames at B=rows (all lanes
    full, masked as the pool runs them when rows > 1), the output copied
    to the host as the server does, over ``timed`` chunks after 10 of
    warm-up; then torch.profiler over 3 chunks: CUDA kernels and copies
    per chunk, device time against wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    C = SERVE_CHUNK
    lengths = np.full(rows, C, np.int32) if rows > 1 else None
    chunks = [np.stack([x[(i * rows + r) * C % (len(x) - C):][:C]
                        for r in range(rows)])
              for i in range(timed + 13)]
    state = enh.init_state(rows)
    times = []
    reset_counts(counters)
    for i, chunk in enumerate(chunks[:timed + 10]):
        t0 = time.perf_counter()
        y, state = enh.step(chunk, state, lengths=lengths)
        y.cpu()
        if i >= 10:
            times.append((time.perf_counter() - t0) * 1e3)
    launches = hand_launches(read_counts(counters))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for chunk in chunks[-3:]:
            y, state = enh.step(chunk, state, lengths=lengths)
            y.cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in events if e.name.startswith(("Memcpy", "Memset"))]
    device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / 3
    ms = np.asarray(times)
    return {"B": rows, "chunk_frames": C, "chunks_timed": len(times),
            "ms_median": float(np.median(ms)),
            "ms_p95": float(np.percentile(ms, 95)),
            "frames_per_s": rows * C / (float(np.median(ms)) / 1e3),
            "kernels_per_chunk": (len(events) - len(copies)) / 3,
            "copies_per_chunk": len(copies) / 3,
            "profiled_wall_ms_per_chunk": wall_ms,
            "device_ms_per_chunk": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "hand_kernel_launches": launches}


def serve_features(work: str, counters: dict) -> dict:
    """Feature mode: cli.serve over the decode phase's 32 utterances and
    checkpoint at --chunk_frames=50, held against cli.train --decode in
    f32 on K4 and on --lstm_impl=scan (<= DECODE_TOL_F32), and against
    itself at 7 and SERVE_LONG_CHUNK frames (bit-equal: every product
    has one step's shape); launch counts set to 0 before each run: none
    while streaming, K4 decode in the reference decode; then ms per chunk
    at B=1 and per pooled step at B=SERVE_POOL."""
    import torch
    from rsrgan_tpu_torch.cli import serve as serve_cli
    from rsrgan_tpu_torch.cli import train as train_cli
    from rsrgan_tpu_torch.data import UtteranceStore, read_list_file
    from rsrgan_tpu_torch.serving import StreamingEnhancer
    data_dir, test_list, lengths = decode_inputs(work)
    ckpt, tree = decode_phase_checkpoint(work)
    common = ["--g_type=res_lstm_l", f"--input_dim={P}",
              f"--output_dim={OUT}", f"--data_dir={data_dir}"]
    out = {"phase": "serve_features", "utterances": len(lengths),
           "frames": int(lengths.sum()), "tf32_off_after": True}

    refs = {}
    for tag, flags in (("kernel", []), ("scan", ["--lstm_impl=scan"])):
        save_dir = os.path.join(work, f"serve_decode_{tag}")
        shutil.copytree(ckpt, save_dir)
        reset_counts(counters)
        secs, _, off = run_cli(train_cli.main, [
            "--decode", "--trainer=gan_rnn", "--bf16=false",
            "--decode_batch_size=16", f"--save_dir={save_dir}", *common,
            f"--test_list_file={test_list}", *flags])
        out[f"decode_{tag}_launches"] = read_counts(counters)
        out[f"decode_{tag}_seconds"] = secs
        out["tf32_off_after"] &= off
        refs[tag] = read_ark(os.path.join(save_dir, "test", "feats.scp"))

    arks = {}
    for chunk in (SERVE_CHUNK, 7, SERVE_LONG_CHUNK):
        d = os.path.join(work, f"serve_c{chunk}")
        reset_counts(counters)
        secs, lines, off = run_cli(serve_cli.main, [
            f"--save_dir={ckpt}", f"--output_dir={d}",
            f"--chunk_frames={chunk}", f"--test_list_file={test_list}",
            *common])
        out[f"c{chunk}"] = {"seconds": secs, "log": lines[-1],
                            "hand_kernel_launches": hand_launches(
                                read_counts(counters))}
        out["tf32_off_after"] &= off
        arks[chunk] = read_ark(os.path.join(d, "feats.scp"))
    main_ark = arks[SERVE_CHUNK]
    out["shapes_ok"] = all(
        main_ark[f"utt{i:04d}"].shape == (int(n), OUT)
        and np.isfinite(main_ark[f"utt{i:04d}"]).all()
        for i, n in enumerate(lengths)) and len(main_ark) == len(lengths)
    for tag, ref in refs.items():
        out[f"vs_decode_{tag}_max_abs"] = max(
            float(np.abs(main_ark[u] - ref[u]).max()) for u in ref)
    out["tol"] = DECODE_TOL_F32
    out["chunk_sizes_bit_equal"] = {
        str(c): list(arks[c]) == list(main_ark) and all(
            np.array_equal(arks[c][u], main_ark[u]) for u in main_ark)
        for c in (7, SERVE_LONG_CHUNK)}
    k4 = out["decode_kernel_launches"]
    out["launches_ok"] = (
        all(out[f"c{c}"]["hand_kernel_launches"] == 0 for c in arks)
        and k4["wavefront_fwd"] > 0
        and hand_launches(k4) == k4["wavefront_fwd"]
        and hand_launches(out["decode_scan_launches"]) == 0)

    store = UtteranceStore(read_list_file(test_list))
    x = np.concatenate([np.asarray(store.inputs(i), np.float32)
                        for i in range(len(store))])
    enh = StreamingEnhancer(tree, device="cuda")
    out["timing"] = {str(rows): chunk_timing(enh, x, rows, chunks, counters)
                     for rows, chunks in ((1, SERVE_TIMED_CHUNKS),
                                          (SERVE_POOL, SERVE_POOL_STEPS))}
    out["ok"] = bool(
        out["shapes_ok"] and out["tf32_off_after"] and out["launches_ok"]
        and all(out[f"vs_decode_{t}_max_abs"] <= DECODE_TOL_F32
                for t in refs)
        and all(out["chunk_sizes_bit_equal"].values())
        and all(t["hand_kernel_launches"] == 0
                for t in out["timing"].values()))
    torch.cuda.synchronize()
    emit(out)
    return out


def noisy_waves(wav_dir: str) -> dict:
    """SERVE_WAVS seeded noisy waves of 2-4 s (speech-like + colored
    noise at 0-15 dB SNR, the port's sim/) as 16-bit wavs and a wav.scp;
    utt -> the samples as read back."""
    from rsrgan_tpu_torch.sim import (make_colored_noise,
                                      make_speech_like_wav, mix_at_snr,
                                      read_wav, write_wav)
    rng = np.random.default_rng(29)
    os.makedirs(wav_dir)
    waves = {}
    with open(os.path.join(wav_dir, "wav.scp"), "w") as scp:
        for i in range(SERVE_WAVS):
            dur = float(rng.uniform(2.0, 4.0))
            wave = mix_at_snr(make_speech_like_wav(rng, dur),
                              make_colored_noise(rng, dur),
                              float(rng.uniform(0.0, 15.0)))
            path = os.path.join(wav_dir, f"noisy{i:02d}.wav")
            write_wav(path, wave)
            scp.write(f"noisy{i:02d} {path}\n")
            waves[f"noisy{i:02d}"] = read_wav(path)[0]
    return waves


def serve_wavs(work: str, counters: dict) -> dict:
    """Wav mode with a full-width LPS->LPS res_lstm_l (257 out): inputs
    normalized by the waves' own LPS statistics, outputs denormalized by
    their mean at unit stddev, shifted so that the waves stay well inside
    16 bits (SERVE_WAV_PEAK, measured on the first wave; every written
    wave's peak below SERVE_WAV_PEAK_MAX). cli.serve single-stream and
    --num_streams=SERVE_POOL: the written wavs within one 16-bit step;
    the library's float waves of the first SERVE_POOL waves pooled
    against single within SERVE_POOL_TOL of the peak, the CLI's single
    stream equal to them as 16-bit PCM, and the single stream against
    the offline chain (cli.train --decode in f32, then resynthesize)
    above SERVE_SNR_DB."""
    from rsrgan_tpu_torch.cli import serve as serve_cli
    from rsrgan_tpu_torch.cli import train as train_cli
    from rsrgan_tpu_torch.data import Cmvn, StoreWriter
    from rsrgan_tpu_torch.eval.metrics import snr
    from rsrgan_tpu_torch.features import (FrameOptions, SpectrogramOptions,
                                           compute_spectrogram_np)
    from rsrgan_tpu_torch.features.resynth import resynthesize
    from rsrgan_tpu_torch.serving import StreamingWavEnhancer, StreamPool
    from rsrgan_tpu_torch.sim import read_wav
    wav_dir = os.path.join(work, "serve_wavs")
    waves = noisy_waves(wav_dir)
    opts = FrameOptions(dither=0.0)
    lps = {u: compute_spectrogram_np(w, SpectrogramOptions(opts))
           for u, w in waves.items()}
    stacked = np.concatenate(list(lps.values()))
    cmvn = Cmvn(stacked.mean(axis=0), stacked.std(axis=0) + 1e-5)
    tree = generator_tree(5, out=P)
    block = SERVE_CHUNK * opts.window_shift

    def stream(enh, w):
        enh.reset()
        return np.concatenate([enh.process(w[lo:lo + block])
                               for lo in range(0, len(w), block)]
                              + [enh.flush()])

    # the waves scale with exp(shift / 2): one wave at shift 0 sets it
    first = next(iter(waves.values()))
    peak0 = float(np.abs(stream(StreamingWavEnhancer(
        tree, cmvn, Cmvn(cmvn.mean, np.ones(P)), frame_opts=opts,
        chunk_frames=SERVE_CHUNK), first)).max())
    shift = 2.0 * float(np.log(SERVE_WAV_PEAK / peak0))
    labels = Cmvn(cmvn.mean + shift, np.ones(P))
    data_dir = os.path.join(work, "serve_wav_data")
    os.makedirs(data_dir)
    np.savez(os.path.join(data_dir, "train_cmvn.npz"),
             mean_inputs=cmvn.mean, stddev_inputs=cmvn.stddev,
             mean_labels=labels.mean, stddev_labels=labels.stddev)
    with StoreWriter(os.path.join(data_dir, "test.rtu")) as store:
        for u, f in lps.items():
            store.add(u, cmvn.apply(f).astype(np.float32))
    test_list = os.path.join(data_dir, "test.list")
    with open(test_list, "w") as f:
        f.write(os.path.join(data_dir, "test.rtu") + "\n")
    ckpt = os.path.join(work, "serve_wav_ckpt")
    g_checkpoint(ckpt, tree, P)
    common = [f"--save_dir={ckpt}", f"--data_dir={data_dir}",
              f"--input_dim={P}", f"--output_dim={P}",
              f"--chunk_frames={SERVE_CHUNK}"]
    samples = sum(len(w) for w in waves.values())
    out = {"phase": "serve_wavs", "waves": len(waves),
           "seconds_of_audio": samples / opts.samp_freq,
           "label_mean_shift": shift, "first_peak_at_shift_0": peak0,
           "tf32_off_after": True}
    written = {}
    for streams in (1, SERVE_POOL):
        d = os.path.join(work, f"serve_wav_out{streams}")
        reset_counts(counters)
        secs, lines, off = run_cli(serve_cli.main, [
            *common, f"--wav_scp={wav_dir}/wav.scp", f"--output_dir={d}",
            f"--num_streams={streams}"])
        out[f"cli_{streams}"] = {
            "seconds": secs, "log": [ln for ln in lines
                                     if ln.startswith(("Pool:",
                                                       "Streaming done"))],
            "hand_kernel_launches": hand_launches(read_counts(counters))}
        out["tf32_off_after"] &= off
        written[streams] = {u: read_wav(os.path.join(d, f"{u}.wav"))[0]
                            for u in waves}
    out["cli_pooled_vs_single_max_abs"] = max(
        float(np.abs(written[1][u] - written[SERVE_POOL][u]).max())
        for u in waves)
    out["lengths_ok"] = all(
        len(written[s][u]) == ((len(w) - opts.window_size)
                               // opts.window_shift) * opts.window_shift
        + opts.window_size for s in written for u, w in waves.items())
    out["written_peak"] = max(float(np.abs(w).max())
                              for ws in written.values() for w in ws.values())

    # the library's float waves, single against pooled (the same feeds as
    # the CLI: SERVE_CHUNK frames of samples a call, all streams open)
    single = StreamingWavEnhancer(tree, cmvn, labels, frame_opts=opts,
                                  chunk_frames=SERVE_CHUNK)
    names = list(waves)[:SERVE_POOL]   # one full pool of lanes
    floats = {u: stream(single, waves[u]) for u in names}
    pool = StreamPool(tree, cmvn, labels, frame_opts=opts,
                      chunk_frames=SERVE_CHUNK, capacity=SERVE_POOL)
    sids = {u: pool.open() for u in names}
    outs = {u: [] for u in names}
    for lo in range(0, max(len(waves[u]) for u in names), block):
        for u in names:
            if lo < len(waves[u]):
                outs[u].append(pool.feed(sids[u], waves[u][lo:lo + block]))
    pooled = {u: np.concatenate(outs[u] + [pool.close(sids[u])])
              for u in names}
    out["pooled_vs_single_rel"] = max(
        float(np.abs(pooled[u] - floats[u]).max() / np.abs(floats[u]).max())
        for u in names)
    out["pool_steps"], out["pool_frames"] = pool.steps_run, pool.frames_run

    # the offline chain: f32 --decode on K4, then resynthesis
    save_dir = os.path.join(work, "serve_wav_decode")
    shutil.copytree(ckpt, save_dir)
    secs, _, off = run_cli(train_cli.main, [
        "--decode", "--trainer=gan_rnn", "--g_type=res_lstm_l",
        "--bf16=false", "--decode_batch_size=16", f"--save_dir={save_dir}",
        f"--data_dir={data_dir}", f"--test_list_file={test_list}",
        f"--input_dim={P}", f"--output_dim={P}"])
    out["tf32_off_after"] &= off
    enhanced = read_ark(os.path.join(save_dir, "test", "feats.scp"))
    snrs = [snr(floats[u], resynthesize(enhanced[u], waves[u], opts))
            for u in names]
    # the CLI's single stream wrote the library's waves, as 16-bit PCM
    out["cli_single_equals_library"] = all(np.array_equal(
        written[1][u], floats[u].astype("<i2")) for u in names)
    out["vs_offline_snr_db_min"] = min(snrs)
    out["vs_offline_snr_db_median"] = float(np.median(snrs))
    out["snr_gate_db"] = SERVE_SNR_DB
    out["pool_tol"] = SERVE_POOL_TOL
    out["peak"] = max(float(np.abs(w).max()) for w in floats.values())
    out["finite"] = all(np.isfinite(w).all() for w in floats.values())
    out["ok"] = bool(
        out["tf32_off_after"] and out["lengths_ok"] and out["finite"]
        and out["cli_single_equals_library"]
        and out["cli_pooled_vs_single_max_abs"] <= 1.0
        and 100.0 < out["written_peak"] < SERVE_WAV_PEAK_MAX
        and out["pooled_vs_single_rel"] <= SERVE_POOL_TOL
        and out["vs_offline_snr_db_min"] > SERVE_SNR_DB
        and all(out[f"cli_{s}"]["hand_kernel_launches"] == 0
                for s in written))
    emit(out)
    return out


def phase_serve(work: str) -> dict:
    """Feature mode, then wav mode."""
    t0 = time.monotonic()
    counters = counter_table()
    feats = serve_features(work, counters)
    wavs = serve_wavs(work, counters)
    out = {"phase": "serve", "seconds": time.monotonic() - t0,
           "ok": feats["ok"] and wavs["ok"]}
    emit(out)
    return out


# The proxy phase: the recognition proxy's classifier on the card, on the
# separable corpus of tests/test_proxy.py, with that test's gates; its
# train rate at the ablation recipes' shape.
PROXY_STEP_TOL = 1e-5   # f32 card step vs CPU step: summation order only
# Adam's first step moves a zero-initialized bias element by
# lr * g / (|g| + eps): where |g| is near eps, its rounding is amplified.
# Each tensor is held at PROXY_STEP_TOL of max(max |ref|, this many lr):
# a weight at its own scale, a bias at 1e-3 lr (a wrong update is O(lr))
PROXY_STEP_FLOOR_LR = 100.0
# the recipes' call (recipes/run_ablation.sh stage 7): --batch=16384 and
# the tool's defaults (context 2, hidden 192, 4 epochs) on 257-dim LPS
PROXY_RATE_DIM = 257
PROXY_RATE_BATCH = 16384
PROXY_RATE_UTTS = 160          # 600-1000 frames each: ~128 k frames


def proxy_corpus(work: str, snr: float, dim: int = 20, utts: int = 40,
                 frames: tuple = (60, 100)) -> tuple:
    """tests/test_proxy.py's synthetic features (class codes + noise at
    ``snr``; its size by default) and alignments: (scp, ali.scp)."""
    from rsrgan_tpu_torch.data import ArkWriter
    from rsrgan_tpu_torch.sim.synthwav import NUM_PHONES
    rng = np.random.default_rng(7)
    codes = rng.normal(size=(NUM_PHONES, dim)).astype(np.float32)
    root = os.path.join(work, f"proxy{dim}")
    os.makedirs(os.path.join(root, "ali"), exist_ok=True)
    scp = os.path.join(root, f"feats_{snr}.scp")
    ali_scp = os.path.join(root, "ali.scp")
    w = ArkWriter(scp)
    with open(ali_scp, "w") as af:
        for i in range(utts):
            n = int(rng.integers(*frames))
            labels = rng.integers(0, NUM_PHONES, size=n)
            labels = np.repeat(labels, 5)[:n].astype(np.int32)
            feats = (codes[labels] * snr
                     + rng.normal(size=(n, dim))).astype(np.float32)
            w.write_next_utt(os.path.join(root, f"feats_{snr}.ark"),
                             f"u{i}", feats)
            path = os.path.join(root, "ali", f"u{i}_{snr}.npy")
            np.save(path, labels)
            af.write(f"u{i} {path}\n")
    w.close()
    return scp, ali_scp


def proxy_step_parity(scp: str, ali_scp: str) -> dict:
    """One f32 train step of the classifier at the tool's default width
    (hidden 192) on 1,024 frames, on the card and on the CPU from the
    same weights: per tensor, the gradients within PROXY_STEP_TOL of
    max |ref| and the post-step parameters within PROXY_STEP_TOL of
    max(max |ref|, PROXY_STEP_FLOOR_LR * lr)."""
    import torch
    from rsrgan_tpu_torch.data import ScpReader
    from rsrgan_tpu_torch.sim.synthwav import NUM_PHONES
    from rsrgan_tpu_torch.tools import proxy_asr
    base, idx, y, _ = proxy_asr.load_corpus(
        ScpReader(scp), proxy_asr.read_alignments(ali_scp), 2)
    mean = np.tile(base.mean(axis=0), 5)[None, :].astype(np.float32)
    std = np.tile(base.std(axis=0) + 1e-5, 5)[None, :].astype(np.float32)
    sel = np.random.default_rng(1).permutation(len(y))[:1024]
    lr = 1e-3
    clfs = {}
    for device in ("cpu", "cuda"):
        clfs[device] = proxy_asr.ProxyClassifier(
            base.shape[1] * 5, NUM_PHONES, 192, lr, seed=0, device=device)
    clfs["cuda"].load_params(clfs["cpu"].numpy_params())
    grads = {}
    for device, clf in clfs.items():
        arrays = [torch.from_numpy(np.ascontiguousarray(a)).to(clf.device)
                  for a in (base, idx, mean, std, sel, y)]
        grads[device] = {k: g.cpu() for k, g in
                         clf.gradients(*arrays)[1].items()}
        clf.train_step(*arrays)
    got, want = ({k: v.cpu() for k, v in clfs[d].params.items()}
                 for d in ("cuda", "cpu"))
    grad_rel = rel_errs(grads["cuda"], grads["cpu"])
    post = {k: float((got[k] - want[k]).abs().max())
            / max(float(want[k].abs().max()), PROXY_STEP_FLOOR_LR * lr)
            for k in want}
    return {"grad_rel_err_by_tensor": grad_rel,
            "post_step_err_by_tensor": post, "tol": PROXY_STEP_TOL,
            "floor_lr": PROXY_STEP_FLOOR_LR,
            "ok": max(grad_rel.values()) <= PROXY_STEP_TOL
            and max(post.values()) <= PROXY_STEP_TOL}


def proxy_rate(work: str) -> dict:
    """The tool's train frames/s as the ablation recipes call it
    (--batch=16384; context 2, hidden 192, 4 epochs) on ~128 k frames of
    257-dim synthetic rows; then torch.profiler over 4 of its steps:
    device time against wall time."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rsrgan_tpu_torch.data import ScpReader
    from rsrgan_tpu_torch.sim.synthwav import NUM_PHONES
    from rsrgan_tpu_torch.tools import proxy_asr
    scp, ali_scp = proxy_corpus(work, 1.0, dim=PROXY_RATE_DIM,
                                utts=PROXY_RATE_UTTS, frames=(600, 1001))
    secs, lines, off = run_cli(proxy_asr.main, [
        f"--train_scp={scp}", f"--ali_scp={ali_scp}",
        f"--batch={PROXY_RATE_BATCH}",
        f"--out={os.path.join(work, 'proxy_rate.json')}"])
    rate = [ln for ln in lines if "train frames/s" in ln][0]
    base, idx, y, _ = proxy_asr.load_corpus(
        ScpReader(scp), proxy_asr.read_alignments(ali_scp), 2)
    clf = proxy_asr.ProxyClassifier(PROXY_RATE_DIM * 5, NUM_PHONES, 192,
                                    1e-3, seed=0, device="cuda")
    mean = np.tile(base.mean(axis=0), 5)[None, :].astype(np.float32)
    std = np.tile(base.std(axis=0) + 1e-5, 5)[None, :].astype(np.float32)
    arrays = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
              for a in (base, idx, mean, std)]
    y_d = torch.from_numpy(y).cuda()
    order = torch.from_numpy(np.random.default_rng(2).permutation(len(y)))
    sels = [order[k * PROXY_RATE_BATCH:(k + 1) * PROXY_RATE_BATCH].cuda()
            for k in range(6)]
    for sel in sels[:2]:
        clf.train_step(*arrays, sel, y_d)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for sel in sels[2:]:
            clf.train_step(*arrays, sel, y_d)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 4
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / 4
    return {"frames": int(len(y)), "dim": PROXY_RATE_DIM * 5,
            "batch": PROXY_RATE_BATCH, "seconds": secs, "log": rate,
            "tf32_off_after": off,
            "train_frames_per_s": float(re.search(
                r"([\d,]+) train frames/s", rate).group(1).replace(",", "")),
            "profiled_wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms,
            "kernels_per_step": len(events) / 4,
            "device_busy_share": device_ms / wall_ms}


def phase_proxy(work: str) -> dict:
    """``tools.proxy_asr.main`` on the card over tests/test_proxy.py's
    separable corpus and its noisy twin, gated as that test gates (clean
    FER < 0.25, noisy FER > clean FER + 0.1, SER <= FER + 0.35), TF32
    turned on before and found off after; no hand kernel launched; the
    card step against the CPU step; the train rate at the recipes'
    shape."""
    from rsrgan_tpu_torch.tools import proxy_asr
    t0 = time.monotonic()
    clean_scp, ali_scp = proxy_corpus(work, 4.0)
    noisy_scp, _ = proxy_corpus(work, 0.3)
    counters = counter_table()
    out_json = os.path.join(work, "proxy20", "proxy.json")
    reset_counts(counters)
    secs, _, off = run_cli(proxy_asr.main, [
        f"--train_scp={clean_scp}", f"--ali_scp={ali_scp}",
        f"--eval=noisy={noisy_scp}", f"--holdout_scp={clean_scp}",
        "--context=1", "--hidden=32", "--epochs=20", "--batch=128",
        "--lr=3e-3", f"--out={out_json}"])
    launches = hand_launches(read_counts(counters))
    with open(out_json) as f:
        result = json.load(f)
    clean, noisy = result["systems"]["clean"], result["systems"]["noisy"]
    step = proxy_step_parity(clean_scp, ali_scp)
    rate = proxy_rate(work)
    out = {"phase": "proxy", "seconds": secs, "result": result,
           "tf32_off_after": off and rate["tf32_off_after"],
           "hand_kernel_launches": launches, "step": step,
           "recipe_rate": rate, "phase_seconds": time.monotonic() - t0}
    out["gates"] = {"clean_fer<0.25": clean["fer"] < 0.25,
                    "noisy_fer>clean_fer+0.1":
                        noisy["fer"] > clean["fer"] + 0.1,
                    "clean_ser<=fer+0.35":
                        0.0 <= clean["ser"] <= clean["fer"] + 0.35}
    out["ok"] = bool(all(out["gates"].values()) and out["tf32_off_after"]
                     and step["ok"] and launches == 0)
    emit(out)
    return out


# The experiments phase: the experiment recipes through the port
# (rsrgan_tpu_torch.tools.experiments) at full width (res_lstm_l and
# LSTM-D, bf16), B=8 (synth_quality: B=4), on corpora cut to the time
# budget. The ablation's corpus: the recipe's assets (4 rooms x 3 RIRs,
# 2-5 s, seed 37, alignments), cut to EXP_UTTS; ablation_mfcc and
# ema_check run on it; ref_scale on its own, rotating >= EXP_REF_SHARDS
# shards.
# The learning rates decay to 1e-4x over --min_epoches (the reference's
# staircase), so each epoch past the first adds little: a larger corpus
# trains more for the same time than more epochs do.
EXP_UTTS, EXP_VAL = 640, 24
EXP_EPOCHS = "2 2"             # min max of each main GAN run and MSE run
EXP_SEEDS = "777 778"          # the aggregate rows need two
EXP_EMA_ITERS = 1
# ref_scale's table gate is the recipe's forced LSD ratio < 0.9: "2 2"
# met it by 3% (0.874), so a third epoch buys margin
EXP_REF_UTTS, EXP_REF_VAL, EXP_REF_EPOCHS = 400, 12, "3 3"
EXP_REF_SHARDS = 3
# The ablation table's thresholds, as the recipe's own environment
# variables (PERF.md gives them before a run). This corpus meets the
# recipe's defaults (LSD ratio < 0.45, ESTOI delta > 0.03) by 1% of the
# ratio and 0.003 of ESTOI, too close to hold across cuBLAS versions and
# cards: the gate sits at 0.5 and 0.0, never below ratio < 1 and
# delta > 0 (the GAN beats no enhancement on both).
EXP_GATE_ENV = {"ABLATION_MAX_LSD_RATIO": "0.5",
                "ABLATION_MIN_ESTOI_DELTA": "0.0"}
# The kernel checks: every shape the recipes launched, at the top of
# their padded lengths (2-5 s: 200-500 frames), every row ragged.
EXP_T = 500
EXP_LENGTHS = [500, 457, 414, 371, 329, 286, 243, 200]
EXP_KERNELS = ("wavefront_fwd_train", "wavefront_fwd", "lstm_fwd",
               "lstm_bwd", "lstm_bwd_acc")


def experiment_run(counters: dict, argv: list, env=None) -> dict:
    """One recipe through experiments.run_recipe on the card, with TF32
    turned on before it (each CLI must turn it off); every launch count
    set to 0 just before each stage and read just after, kept for the
    stages that launched a hand kernel."""
    import contextlib

    import torch
    from rsrgan_tpu_torch.tools import experiments
    launches = {}

    @contextlib.contextmanager
    def counted(stage):
        reset_counts(counters)
        yield
        torch.cuda.synchronize()
        counts = read_counts(counters)
        if any(counts[k] for k in EXP_KERNELS):
            launches[stage] = counts

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    with experiments.env_defaults(env or {}, {}):
        rc, res = experiments.run_recipe(
            experiments.build_parser().parse_args(argv + ["--device=cuda"]),
            stage_context=counted)
    tf32_off = not (torch.backends.cuda.matmul.allow_tf32
                    or torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {**res, "rc": rc, "launches": launches,
            "tf32_off_after": tf32_off}


def on_recipe_routes(launches: dict) -> bool:
    """K4 train, K1 and K2 in every train stage, K4 decode in every
    decode stage, each stage on its own kernels; K3 nowhere: at B=8 (and
    synth_quality's 4, micro's 2) every backward has 2-16 rows, below
    ACC_BWD_MIN_BATCH."""
    ok = bool(launches)
    for stage, c in launches.items():
        ok &= c["lstm_bwd_acc"] == 0
        if "train" in stage:
            ok &= (c["wavefront_fwd_train"] > 0 and c["lstm_bwd"] > 0
                   and (c["lstm_fwd"] > 0 or "mse" in stage))
        else:
            ok &= (c["wavefront_fwd"] > 0 and c["wavefront_fwd_train"]
                   == c["lstm_bwd"] == 0)
    return bool(ok)


def proxy_below_noisy(res: dict) -> dict:
    """Each trained system's proxy FER below the noisy input's."""
    systems = res["systems"]
    return {n: systems[n]["proxy_fer"] < systems["noisy"]["proxy_fer"]
            for n in res["systems_trained"]}


def keep_launches(launches: dict) -> dict:
    keep = EXP_KERNELS + tuple(f"{k}_by_shape" for k in EXP_KERNELS
                               if k != "lstm_bwd_acc")
    return {s: {k: c[k] for k in keep} for s, c in launches.items()}


def ref_scale_budget(train_dir: str) -> int:
    """An RSRGAN_FEED_HBM_BUDGET that cuts the ref_scale train tables
    into >= EXP_REF_SHARDS shards of bf16 rows with prefetch's two
    buffers, beside the resident cv tables."""
    from rsrgan_tpu_torch.data import UtteranceStore
    from rsrgan_tpu_torch.data.device_feed import table_bytes
    tr = UtteranceStore([f"{train_dir}/stores/tr.rtu"])
    cv = UtteranceStore([f"{train_dir}/stores/cv.rtu"])
    return table_bytes(cv, 2) + 2 * table_bytes(tr, 2) // EXP_REF_SHARDS


def phase_experiments(work: str) -> dict:
    """The six experiment recipes through the port at full width: (a)
    ablation (two seeds, weight 10: the aggregate rows), (b)
    ablation_mfcc and (c) ema_check on (a)'s corpus, (d) ref_scale on
    rotating shards, (e) synth_quality, (f) micro (run_micro.sh at its
    own size, B=2); each recipe's gate, the proxy's
    FER of every trained system below the noisy FER, TF32 off after the
    CLIs, the launch routes; then each kernel at every shape the recipes
    launched, against its twin in f32 and bf16."""
    t0 = time.monotonic()
    counters = chain_counters()
    abl = os.path.join(work, "exp_ablation")
    runs, checks = {}, {}

    def line(name, res, ok, **extra):
        out = {"phase": f"experiments_{name}",
               **{k: v for k, v in res.items() if k != "launches"},
               "launches": keep_launches(res["launches"]), **extra}
        out["routes_ok"] = on_recipe_routes(res["launches"])
        out["ok"] = bool(ok and out["routes_ok"] and res["tf32_off_after"])
        emit(out)
        runs[name], checks[name] = out, out["ok"]

    res = experiment_run(counters, [
        "--recipe=ablation", f"--workdir={abl}", f"--num_utts={EXP_UTTS}",
        f"--val_size={EXP_VAL}", f"--gan_epochs={EXP_EPOCHS}",
        f"--mse_epochs={EXP_EPOCHS}", f"--seeds={EXP_SEEDS}",
        "--mse_weights=10"], EXP_GATE_ENV)
    fer = proxy_below_noisy(res)
    seeds_differ = (res["systems"]["gan"]["mse"]
                    != res["systems"]["gan_w10_s778"]["mse"])
    line("ablation", res, res["passed"] and all(fer.values())
         and seeds_differ, gate_env=EXP_GATE_ENV,
         proxy_fer_below_noisy=fer, seeds_differ=seeds_differ)

    res = experiment_run(counters, [
        "--recipe=ablation_mfcc", f"--lps_workdir={abl}",
        f"--workdir={os.path.join(work, 'exp_ablation_mfcc')}",
        f"--val_size={EXP_VAL}", f"--gan_epochs={EXP_EPOCHS}",
        f"--mse_epochs={EXP_EPOCHS}", "--seeds=777"])
    fer = proxy_below_noisy(res)
    line("ablation_mfcc", res, res["passed"] and all(fer.values()),
         proxy_fer_below_noisy=fer)

    res = experiment_run(counters, [
        "--recipe=ema_check", f"--lps_workdir={abl}",
        f"--workdir={os.path.join(work, 'exp_ema')}",
        f"--iters={EXP_EMA_ITERS}"])
    v = res["verdict"]
    finite = all(np.isfinite(v[s][k]) for s in ("raw", "ema")
                 for k in ("feature_mse", "lsd_db"))
    line("ema_check", res, finite
         and v["train_iterations_run"] == EXP_EMA_ITERS,
         decodes_finite=finite)

    ref = os.path.join(work, "exp_ref_scale")
    ref_argv = ["--recipe=ref_scale", f"--workdir={ref}",
                f"--num_utts={EXP_REF_UTTS}", f"--val_size={EXP_REF_VAL}",
                f"--gan_epochs={EXP_REF_EPOCHS}",
                f"--mse_epochs={EXP_REF_EPOCHS}", "--rot_block=2",
                "--prefetch=true"]
    first = experiment_run(counters, ref_argv + ["--stop_stage=3"])
    budget = ref_scale_budget(os.path.join(ref, "data", "train"))
    res = experiment_run(counters, ref_argv + ["--stage=4"],
                         {"RSRGAN_FEED_HBM_BUDGET": str(budget)})
    res["stage_seconds"] = {**first["stage_seconds"],
                            **res["stage_seconds"]}
    res["seconds"] += first["seconds"]
    res["tf32_off_after"] &= first["tf32_off_after"]
    fer = proxy_below_noisy(res)
    rotated = {n: s["residencies"] for n, s in
               res["systems_trained"].items()}
    line("ref_scale", res, res["passed"] and all(fer.values())
         and all(n > 1 for n in rotated.values()) and len(rotated) == 2,
         feed_budget_bytes=budget, residencies=rotated,
         proxy_fer_below_noisy=fer,
         waves_deleted=not os.path.exists(os.path.join(ref, "sim",
                                                       "clean")))

    res = experiment_run(counters, [
        "--recipe=synth_quality",
        f"--workdir={os.path.join(work, 'exp_quality')}"])
    line("synth_quality", res, res["passed"])

    res = experiment_run(counters, [
        "--recipe=micro", f"--workdir={os.path.join(work, 'exp_micro')}"])
    line("micro", res, res["passed"] and res["check"]["passed"])

    t1 = time.monotonic()
    shapes = chain_shapes(runs)
    kernels = {d: [chain_kernel(name, key, d, EXP_T, EXP_LENGTHS,
                                "experiments_kernels")
                   for name, key in shapes]
               for d in ("float32", "bfloat16")}
    out = {"phase": "experiments", "seconds": time.monotonic() - t0,
           "kernel_check_seconds": time.monotonic() - t1,
           "recipe_seconds": {n: r["seconds"] for n, r in runs.items()},
           "shapes_checked": [f"{n} {k}" for n, k in shapes],
           "checks": checks,
           "ok": (all(checks.values())
                  and all(r["ok"] for rs in kernels.values() for r in rs))}
    emit(out)
    out["kernels"] = kernels
    out["launches"] = {n: r["launches"] for n, r in runs.items()}
    return out


# The tools phase: the port's measurement tools as processes on the card,
# the kernel tools at their defaults (full width, B=16, T=500).
TOOL_RUNS = (("kernel_bench", []), ("profile_step", []),
             ("serve_bench", ["20"]), ("io_bench", []))
KERNEL_TOOLS = ("kernel_bench", "profile_step")
TOOL_TIMEOUT = 300
COUNTED_TOOL = ("import sys, chip_smoke; "
                "sys.exit(chip_smoke.counted_tool(sys.argv[1], sys.argv[2], "
                "sys.argv[3:]))")
KERNEL_BENCH_NAMES = ("g_infer", "g_fwd", "g_fwdbwd", "d_fwd2b", "d_fwdbwd",
                      "full")
IO_STAGES = ("ark-plain", "ark-bcm-np", "store-build", "store-scan",
             "batcher-0ctx", "batcher", "prefetch")
# the hand kernels a profiled flagship step at B=16 runs, as kernel rows
STEP_HAND_KERNELS = ("wavefront_resident_kernel", "lstm_fwd_rowgroup_kernel",
                     "lstm_bwd_resident_kernel", "lstm_bwd_rowgroup_kernel",
                     "lstm_wgrad_kernel")


def counted_tool(counts_path: str, name: str, argv: list) -> int:
    """``rsrgan_tpu_torch.tools.{name}.main(argv)`` in this process, every
    launch count set to 0 just before it and written to ``counts_path``
    (JSON) just after."""
    import importlib

    import torch
    counters = chain_counters()
    reset_counts(counters)
    rc = importlib.import_module(f"rsrgan_tpu_torch.tools.{name}").main(argv)
    torch.cuda.synchronize()
    with open(counts_path, "w") as f:
        json.dump(read_counts(counters), f)
    return rc


def run_tool(name: str, argv: list, work: str) -> dict:
    """One tool as a process on the card through ``counted_tool``, with a
    time limit: its exit code, seconds, printed lines (the JSON ones
    parsed) and launch counts."""
    counts_path = os.path.join(work, f"tool_counts_{name}.json")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-c", COUNTED_TOOL, counts_path, name, *argv,
         "--device=cuda"], cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
        capture_output=True, text=True, timeout=TOOL_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    out = {"rc": proc.returncode, "seconds": time.monotonic() - t0,
           "card": lines[0] if lines else None,
           "lines": [ln for ln in lines[1:] if not ln.startswith("{")],
           "json": [json.loads(ln) for ln in lines if ln.startswith("{")],
           "launches": None}
    if proc.returncode == 0:
        with open(counts_path) as f:
            out["launches"] = json.load(f)
    else:
        out["stderr_tail"] = proc.stderr[-3000:]
    return out


def tool_checks(name: str, r: dict) -> dict:
    """Each tool's lines: the JAX tool's metric and keys, finite and
    positive where they are times or rates; the kernel tools on the hand
    kernels (their launches, profile_step's kernel rows), serve_bench on
    none."""
    js = r["json"]
    last = js[-1] if js else {}
    c = r["launches"] or {}
    if name == "kernel_bench":
        return {"metric": last.get("metric") == "kernel_bench_ms",
                "segments": all(np.isfinite(last.get(n, np.nan))
                                and last[n] > 0 for n in KERNEL_BENCH_NAMES),
                "text_lines": [ln.split()[0] for ln in r["lines"]]
                == list(KERNEL_BENCH_NAMES),
                "launches": all(c.get(k, 0) > 0 for k in (
                    "wavefront_fwd", "wavefront_fwd_train", "lstm_fwd",
                    "lstm_bwd", "lstm_bwd_acc"))}
    if name == "profile_step":
        rollup = last.get("rollup_ms_per_step", {})
        share = last.get("device_busy_share") or 0
        return {"metric": last.get("metric") == "profile_step",
                "steps": last.get("step_ranges") == 10,
                "busy_share": 0 < share <= 1,
                "hand_kernel_rows": all(rollup.get(f"hand kernel {k}", 0) > 0
                                        for k in STEP_HAND_KERNELS),
                "host_by_function": bool(last.get(
                    "host_ms_per_step_by_function")),
                "launches": all(c.get(k, 0) > 0 for k in (
                    "wavefront_fwd_train", "lstm_fwd", "lstm_bwd",
                    "lstm_bwd_acc"))}
    if name == "serve_bench":
        grid = [(j.get("lanes"), j.get("chunk_frames")) for j in js]
        return {"metric": all(j.get("metric") == "stream_step_latency_ms"
                              for j in js),
                "grid": grid == [(n, f) for n in (1, 8, 32, 64)
                                 for f in (10, 50)],
                "latencies": all(0 < j["p50"] <= j["p95"] <= j["p99"]
                                 for j in js),
                "no_hand_kernel": hand_launches(c) == 0}
    return {"metric": last.get("metric") == "io_bench_frames_per_sec",
            "stages": list(k for k in last if k != "metric")
            == list(IO_STAGES),
            "rates": all(last.get(k, 0) > 0 for k in IO_STAGES)}


def train_shape_key(r: dict) -> str:
    """A kernels_train check's shape as the wrappers' ``shape_key``."""
    if r["kernel"].startswith("wavefront"):
        return (f"L={r['L']},U={r['U']},P={r['P']},B={r['B']},"
                f"residual={0 if r.get('net') == 'G_lstm' else 1}")
    return f"U={r['U']},P={r['P']},B={r['B']}"


def held_shapes(results: dict) -> dict:
    """(wrapper, shape_key) -> (phase, {dtype: check}) of every shape an
    earlier phase held against its twin in f32 and bf16: K4 decode at
    B=16 (phase kernel), the kernels_train shapes, and the shapes of the
    chain and parallel phases."""
    held = {}
    if "kernel" in results:
        held[("wavefront_fwd", f"L={L},U={U},P={P},B={B},residual=1")] = (
            "kernel", {d: {**r, **wavefront_bound(L, U, P, B, T, LENGTHS, d,
                                                  train=False)}
                       for d, r in results["kernel"].items()})
    if "kernels_train" in results:
        kt = results["kernels_train"]
        for r32, r16 in zip(kt["float32"], kt["bfloat16"]):
            held.setdefault((r16["kernel"], train_shape_key(r16)), (
                "kernels_train", {"float32": r32, "bfloat16": r16}))
    for phase in ("chain", "parallel"):
        if phase in results:
            ks = results[phase]["kernels"]
            for r32, r16 in zip(ks["float32"], ks["bfloat16"]):
                held.setdefault((r16["kernel"], r16["shape"]), (
                    phase, {"float32": r32, "bfloat16": r16}))
    return held


def phase_tools(work: str, results: dict, card: str) -> dict:
    """The four measurement tools as processes on the card (kernel_bench
    and profile_step at full width, B=16, T=500; serve_bench at 20
    chunks; io_bench at its defaults), each to exit 0 and print its
    lines after the card's; the kernel tools' launches by shape, and
    every shape they launched held against its twin in f32 and bf16
    (anew where no earlier phase held it)."""
    t0 = time.monotonic()
    runs, checks = {}, {}
    for name, argv in TOOL_RUNS:
        r = run_tool(name, argv, work)
        r["checks"] = tool_checks(name, r) if r["rc"] == 0 else {}
        r["checks"]["card_line"] = r["card"] == card
        runs[name], checks[name] = r, (r["rc"] == 0
                                       and all(r["checks"].values()))
    t1 = time.monotonic()
    shapes = sorted({(k, key) for t in KERNEL_TOOLS
                     for k in EXP_KERNELS
                     for key in (runs[t]["launches"] or {}).get(
                         f"{k}_by_shape", {})})
    held = held_shapes(results)
    kernels = []
    for k, key in shapes:
        phase, by_dtype = held.get((k, key), ("tools", None))
        if by_dtype is None:
            by_dtype = {d: chain_kernel(k, key, d, TT, TRAIN_LENGTHS,
                                        "tools_kernels")
                        for d in ("float32", "bfloat16")}
        kernels.append({"kernel": k, "shape": key, "held_in": phase,
                        "launches": {t: n for t in KERNEL_TOOLS if (
                            n := (runs[t]["launches"] or {}).get(
                                f"{k}_by_shape", {}).get(key, 0))},
                        **by_dtype})
    out = {"phase": "tools", "seconds": time.monotonic() - t0,
           "kernel_check_seconds": time.monotonic() - t1,
           "tool_seconds": {n: r["seconds"] for n, r in runs.items()},
           **{n: {k: v for k, v in r.items() if k != "seconds"}
              for n, r in runs.items()},
           "shapes": [{"kernel": e["kernel"], "shape": e["shape"],
                       "held_in": e["held_in"], "launches": e["launches"],
                       "ok": all(e[d]["ok"] for d in ("float32",
                                                      "bfloat16"))}
                      for e in kernels],
           "checks": checks}
    out["ok"] = bool(all(checks.values()) and shapes
                     and all(e["ok"] for e in out["shapes"]))
    emit(out)
    out["kernels"] = kernels
    return out


def card_name_and_limit() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True)
    return proc.stdout.strip().splitlines()[0]


PHASES = ("build", "kernel", "kernels_train", "grad", "prepare", "train",
          "train_mse", "train_frame", "segan", "parallel", "feed", "decode",
          "chain", "serve", "tools", "proxy", "experiments")


def kernel_entry(name, source, replaces, launches, launches_per, result,
                 bound_keys):
    extra = {k: result[k] for k in ("grid", "design", "streaming_ms",
                                    "rowgroup_ms", "us_per_step", "walk_ms",
                                    "reduction_ms", "walk_bound_ms",
                                    "reduction_bound_ms", "library_ms",
                                    "library_bf16_ms",
                                    "library_max_abs_diff", "library_of",
                                    "host_ms", "plain_host_ms",
                                    "bound_bytes")
             if k in result}
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_per": launches_per,
            "max_abs_err": (max(result["max_abs_err"].values())
                            if isinstance(result["max_abs_err"], dict)
                            else result["max_abs_err"]),
            "ms": result["ms"], "plain_ms": result["plain_ms"],
            "bound_ms": bound_keys["bound_ms"],
            "bound_by": bound_keys["bound_by"],
            # no single PyTorch call computes K1, K2, K4 or K3's walk: the
            # cell has peepholes and a projection, which torch.nn.LSTM and
            # cuDNN do not; K3's reduction has its library time (extra)
            "library_ms": None, **extra}


def kernels_line(results: dict) -> dict:
    """One entry per kernel: launches from the main-path runs (train and
    decode phases; ``launches_per`` names the run), error and times from
    the bf16 kernel phases at the main path's shapes, bounds from those
    phases' inputs; then one entry per shape that the chains, one per
    shape that the data-parallel ranks, and one per shape that the
    experiment recipes launched, from the bf16 check at that shape."""
    labels = {"wavefront_fwd_train": ("wavefront_fwd (train, "
                                      "save_acts=True", REPLACES),
              "wavefront_fwd": ("wavefront_fwd (decode, save_acts=False",
                                REPLACES),
              "lstm_fwd": ("lstm_fwd (K1", "rsrgan_tpu/ops/pallas_lstm.py:74"),
              "lstm_bwd": ("lstm_bwd (K2",
                           "rsrgan_tpu/ops/pallas_lstm.py:196"),
              "lstm_bwd_acc": ("lstm_bwd_acc (K3",
                               "rsrgan_tpu/ops/pallas_lstm.py:364")}
    dec = results["kernel"]["bfloat16"]
    entries = [kernel_entry(
        "wavefront_fwd (decode, save_acts=False)", RESIDENT, REPLACES,
        results["decode"]["launches"], "decode run (32 utterances)", dec,
        wavefront_bound(L, U, P, B, T, LENGTHS, "bfloat16", train=False))]
    if "kernels_train" in results:
        epoch = results["train"]["launches"]
        dropout, lstm = results["train"]["dropout"], results["train"]["lstm"]
        # K3 at G width runs at the CLI's default batch, not at B=16: its
        # launches are the profiled B=32 step's
        step32 = results["train"]["profile_bf16_step_b32"]["launches"]
        # --trainer=rnn's launches (the train_mse phase): G alone
        mse_runs = {}
        if "train_mse" in results:
            mse = results["train_mse"]
            per16 = (f"rnn epoch at B=16, device feed "
                     f"({int(mse['speed']['steps'])} iterations)")
            mse_runs = {
                ("wavefront_fwd_train", None, B): (
                    mse["launches"]["wavefront_fwd_train"], per16),
                ("lstm_bwd", "G", B): (mse["launches"]["lstm_bwd"], per16),
                ("lstm_bwd_acc", "G", 2 * B): (
                    mse["b32"]["launches"]["lstm_bwd_acc_resident"],
                    f"rnn epoch at B=32 "
                    f"({int(mse['b32']['speed']['steps'])} iterations)")}
        by_name = {}
        for r in results["kernels_train"]["bfloat16"]:
            by_name.setdefault((r["kernel"], r.get("net"), r.get("B")), r)
        for key, label, source, replaces in (
                (("wavefront_fwd_train", None, B),
                 "wavefront_fwd (train, save_acts=True)", RESIDENT,
                 REPLACES),
                (("lstm_fwd", "D", B), "lstm_fwd (K1, D forward, B=16)",
                 RESIDENT, "rsrgan_tpu/ops/pallas_lstm.py:74"),
                (("lstm_fwd", "D", 2 * B),
                 "lstm_fwd (K1, D forward, 32 rows)", RESIDENT,
                 "rsrgan_tpu/ops/pallas_lstm.py:74"),
                (("lstm_bwd", "G", B), "lstm_bwd (K2, G layer, B=16)",
                 RESIDENT, "rsrgan_tpu/ops/pallas_lstm.py:196"),
                (("lstm_bwd", "D", B), "lstm_bwd (K2, D layer, B=16)",
                 RESIDENT, "rsrgan_tpu/ops/pallas_lstm.py:196"),
                (("lstm_bwd_acc", "D", 2 * B),
                 "lstm_bwd_acc (K3, D step, 32 rows: the row-group walk "
                 "lstm_bwd_rowgroup_kernel, then its reduction "
                 "lstm_wgrad_kernel)", RESIDENT,
                 "rsrgan_tpu/ops/pallas_lstm.py:364"),
                (("lstm_bwd_acc", "G", 2 * B),
                 "lstm_bwd_acc (K3, G layer, B=32: the resident walk "
                 "lstm_bwd_resident_kernel in acc mode, then its reduction "
                 "lstm_wgrad_kernel)", RESIDENT,
                 "rsrgan_tpu/ops/pallas_lstm.py:364"),
                (("lstm_fwd", "G", B),
                 "lstm_fwd (K1, G layer at U=760, P=257, B=16: res_lstm_l "
                 "with --keep_prob < 1, res_lstm_i, rnn with --keep_prob "
                 "< 1; on K4's resident grid at L = 1)", RESIDENT,
                 "rsrgan_tpu/ops/pallas_lstm.py:74"),
                (("wavefront_fwd_train", "G_lstm", B),
                 "wavefront_fwd (train, save_acts=True; --g_type=lstm: L=3, "
                 "P=280, residual off)", RESIDENT, REPLACES)):
            r = by_name[key]
            if r.get("route") == "resident":
                runs = (step32["lstm_bwd_acc_resident"],
                        "one profiled train step at B=32")
            elif key == ("lstm_fwd", "G", B):
                runs = (dropout["k1_g_width_launches"],
                        "dropout epoch at B=16 (--keep_prob=0.8, device "
                        "feed, 8 iterations), K1 launches at U=760")
            elif key[1] == "G_lstm":
                runs = (lstm["launches"]["wavefront_fwd_train"],
                        "--g_type=lstm epoch at B=16 (device feed, 8 "
                        "iterations)")
            else:
                runs = (epoch[key[0]],
                        "train epoch at B=16, device feed (8 iterations, "
                        "cv pass)")
            entry = kernel_entry(label, source, replaces, *runs, r, r)
            if "train_mse" in results and key in mse_runs:
                entry["launches_mse"], entry["launches_mse_per"] = \
                    mse_runs[key]
            if key == ("lstm_fwd", "G", B):
                res_i = results["train"]["res_lstm_i"]
                entry["launches_res_lstm_i"] = {
                    "epoch": res_i["k1_g_width_launches"],
                    "decode": res_i["decode"]["launches"]["lstm_fwd"]}
                if "train_mse" in results:
                    entry["launches_rnn_dropout"] = results["train_mse"][
                        "dropout"]["k1_g_width_launches"]
            entries.append(entry)
    if "kernels_train_optim" in results:
        # the fused optimizer update: its launches in the flagship's
        # main-path epoch (G's Adam, D's SGD) and SEGAN's epoch (RMSProp)
        runs = {"G": ("train", "train epoch at B=16, device feed (8 "
                      "iterations: 2 G updates and 1 D update each)"),
                "D": ("train", "the same epoch"),
                "segan_G": ("segan", "the segan epoch (run_segan.sh's "
                            "flags)"),
                "segan_D": ("segan", "the same epoch")}
        for r in results["kernels_train_optim"]:
            if r["layout"] == "flat":
                continue
            phase, per = runs[r["net"]]
            counts = (results[phase]["launches"]["optim"] if phase == "train"
                      else results[phase]["optim_launches"])
            entries.append(kernel_entry(
                f"optim_update ({r['optimizer']}"
                f"{', clip 15' if r['clip'] else ''}, {r['net']}: "
                f"{r['leaves']} leaves, {r['elements']} elements; "
                "sumsq_kernel then update_kernel)",
                "rsrgan_tpu_torch/csrc/optim.cu",
                "none (optax's per-leaf update, rsrgan_tpu/training/"
                "state.py, left to XLA)",
                counts["by_shape"].get(
                    f"{r['optimizer']} leaves={r['leaves']}", 0), per, r, r))
    for entry in entries:
        entry["launches_chain"] = None  # shapes the chains do not run
    if "chain" in results:
        # one entry per shape the chains launched: its checks at that
        # shape, its launches there in each chain's train and decode
        chain = results["chain"]
        for r in chain["kernels"]["bfloat16"]:
            label, replaces = labels[r["kernel"]]
            per = {f"{t}_{stage}": counts[f"{r['kernel']}_by_shape"].get(
                       r["shape"], 0)
                   for t, stages in chain["launches"].items()
                   for stage, counts in stages.items()}
            entry = kernel_entry(
                f"{label}; recipe chains at {r['shape']})", RESIDENT,
                replaces, sum(per.values()),
                "both recipe chains' train and decode stages (96 "
                f"utterances, {CHAIN_EPOCHS} epochs, --batch_size=4)", r, r)
            entry["launches_chain"] = per
            entries.append(entry)
    for entry in entries:
        entry["launches_parallel"] = None  # shapes no rank runs
    if "parallel" in results:
        # one entry per shape a data-parallel rank launched: its check at
        # that shape, each rank's launches there in each run
        par = results["parallel"]
        for r in par["kernels"]["bfloat16"]:
            label, replaces = labels[r["kernel"]]
            per = par["launches_by_shape"][f"{r['kernel']} {r['shape']}"]
            entry = kernel_entry(
                f"{label}; a data- or tensor-parallel rank at "
                f"{r['shape']})", RESIDENT,
                replaces, sum(sum(ranks) for ranks in per.values()),
                "every rank of the parallel phase's runs (the f32 library "
                "step, the recipe's bf16 two-process epoch, the f32 "
                "two-process decode, the f32 tensor-parallel steps tp_e1 "
                "and tp_e2; launches_parallel: run -> each rank's "
                "launches)", r, r)
            entry["launches_chain"] = None
            entry["launches_parallel"] = per
            entries.append(entry)
    for entry in entries:
        entry["launches_tools"] = None  # shapes the tools do not run
    if "tools" in results:
        # one entry per shape the kernel tools launched: its check at that
        # shape (anew, or the earlier phase's that held it), its launches
        # there in each tool
        for e in results["tools"]["kernels"]:
            label, replaces = labels[e["kernel"]]
            entry = kernel_entry(
                f"{label}; measurement tools at {e['shape']})", RESIDENT,
                replaces, sum(e["launches"].values()),
                "tools.kernel_bench's segments and full step (B=16, T=500; "
                "5 windows of 20) and tools.profile_step's 21 steps "
                "(launches_tools: tool -> launches)", e["bfloat16"],
                e["bfloat16"])
            entry.update(launches_chain=None, launches_parallel=None,
                         launches_tools=e["launches"],
                         held_in=e["held_in"])
            entries.append(entry)
    for entry in entries:
        entry["launches_experiments"] = None  # shapes no recipe runs
    if "experiments" in results:
        # one entry per shape the experiment recipes launched: its check
        # at that shape, its launches there in each recipe's stages
        exp = results["experiments"]
        for r in exp["kernels"]["bfloat16"]:
            label, replaces = labels[r["kernel"]]
            per = {f"{recipe} {stage}": n
                   for recipe, stages in exp["launches"].items()
                   for stage, counts in stages.items()
                   if (n := counts[f"{r['kernel']}_by_shape"].get(
                       r["shape"], 0))}
            entry = kernel_entry(
                f"{label}; experiment recipes at {r['shape']})", RESIDENT,
                replaces, sum(per.values()),
                "the experiment recipes' train and decode stages "
                "(ablation, ablation_mfcc, ema_check and ref_scale at "
                "--batch_size=8, synth_quality at 4; launches_experiments: "
                "recipe and stage -> launches)", r, r)
            entry.update(launches_chain=None, launches_parallel=None,
                         launches_tools=None, launches_experiments=per)
            entries.append(entry)
    return {"kernels": entries}


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    phases = parser.parse_args(argv).phases.split(",")
    if not os.path.isdir(os.path.join(HERE, "rsrgan_tpu_torch")):
        return fail("rsrgan_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    try:
        import torch
    except ImportError as e:
        return fail(f"torch is not importable ({e})")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)

    card = card_name_and_limit()
    emit({"phase": "card", "name, power.limit": card})
    results, oks, seconds = {}, [], {}
    t_start = time.monotonic()

    def clocked(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        seconds[name] = seconds.get(name, 0.0) + time.monotonic() - t0
        return out

    clocked("build", phase_build)
    if "kernel" in phases:
        results["kernel"] = {d: clocked("kernel", phase_kernel, d)
                             for d in ("float32", "bfloat16")}
        small = clocked("kernel", phase_kernel_small)
        oks += [r["ok"] for r in results["kernel"].values()] + [small["ok"]]
    if "kernels_train" in phases:
        results["kernels_train"] = {
            d: clocked("kernels_train", phase_kernels_train, d)
            for d in ("float32", "bfloat16")}
        small = clocked("kernels_train", phase_kernels_train_small)
        results["kernels_train_optim"] = clocked(
            "kernels_train", phase_kernels_train_optim)
        oks += [r["ok"] for rs in results["kernels_train"].values()
                for r in rs] + [small["ok"]]
        oks += [r["ok"] for r in results["kernels_train_optim"]]
    if "grad" in phases:
        oks.append(clocked("grad", phase_grad)["ok"])
    with tempfile.TemporaryDirectory() as work:
        # the train phases train from the prepare phase's stores
        if {"prepare", "train", "train_mse", "train_frame",
                "segan", "parallel"} & set(phases):
            prepared = clocked("prepare", phase_prepare, work)
            oks.append(prepared["ok"])
        if "train" in phases:
            results["train"] = clocked("train", phase_train, work,
                                       prepared["lists"])
            oks.append(results["train"]["ok"])
        if "train_mse" in phases:
            flagship = (speed_of(results["train"])
                        if "train" in results else None)
            results["train_mse"] = clocked("train_mse", phase_train_mse, work,
                                           prepared["lists"], flagship)
            oks.append(results["train_mse"]["ok"])
        if "train_frame" in phases:
            oks.append(clocked("train_frame", phase_train_frame, work,
                               prepared["lists"])["ok"])
        if "segan" in phases:
            results["segan"] = clocked("segan", phase_segan, work,
                                       prepared["lists"])
            oks.append(results["segan"]["ok"])
        if "parallel" in phases:
            results["parallel"] = clocked("parallel", phase_parallel, work,
                                          prepared["lists"])
            oks.append(results["parallel"]["ok"])
        if "feed" in phases:
            oks.append(clocked("feed", phase_feed, work)["ok"])
        if "decode" in phases:
            results["decode"] = clocked("decode", phase_decode, work)
            oks.append(results["decode"]["ok"])
        if "chain" in phases:
            results["chain"] = clocked("chain", phase_chain, work)
            oks.append(results["chain"]["ok"])
        if "serve" in phases:
            oks.append(clocked("serve", phase_serve, work)["ok"])
        if "tools" in phases:
            results["tools"] = clocked("tools", phase_tools, work, results,
                                       card)
            oks.append(results["tools"]["ok"])
        if "proxy" in phases:
            oks.append(clocked("proxy", phase_proxy, work)["ok"])
        if "experiments" in phases:
            results["experiments"] = clocked("experiments", phase_experiments,
                                             work)
            oks.append(results["experiments"]["ok"])
    emit({"phase": "timing", "seconds": seconds,
          "total_seconds": time.monotonic() - t_start,
          "name, power.limit": card})
    if not all(oks):
        return fail("a phase failed (see the lines with \"ok\": false)")
    if set(phases) != set(PHASES):
        return fail(f"only phases {phases} ran; no result")

    emit(kernels_line(results))
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
