"""Train/decode entry point of the port (``rsrgan_tpu/cli/train.py``).

The flags are the JAX CLI's, plus ``--device``. This port runs, on
``--device`` (default ``cuda``; it raises when there is no card unless
``--device=cpu`` is given):

* the sequence trainers: ``--trainer gan_rnn`` (the flagship LSGAN: 1 D +
  2 G steps per batch on the same batch, or with ``--same_batch=false``
  D and G steps on successive batches, the graph-fed loop;
  ``--d_conditioned``) and ``--trainer rnn`` (the MSE trainer, G alone);
  ``--g_type lstm|res_lstm_*``; ``--keep_prob`` (dropout between the
  LSTM layers of G and of D; G then runs per layer, K1 forward, as in
  JAX); CV eval, the completed-epoch schedules, accept/reject. Batches
  run in the JAX CLI's update order (``dispatch_order``: same-shape
  groups of ``--steps_per_call``). Their feed: ``--device_feed`` (auto:
  on where ``--device`` is a card) keeps the corpus resident on the
  device and gathers each batch there from a ``[B]`` plan, rotating
  resident shards (``--feed_rotation_block``, ``--feed_prefetch``) when
  the tables exceed ``RSRGAN_FEED_HBM_BUDGET``; otherwise, and for the
  graph-fed loop, a prefetch thread builds host batches;
* ``--g_type bnlstm`` (recurrent batch norm, the eager cell) with
  ``--trainer rnn``; ``--trainer gan_rnn`` refuses it, as the JAX package
  cannot train it;
* the frame trainers, in f32 whatever ``--bf16`` says: ``--trainer dnn``
  (MSE, ``--g_type dnn|rced|cnn``, ``--batch_norm`` for dnn and rced),
  ``--trainer gan_dnn`` (the frame LSGAN, D conditioned on the center
  input frame; ``--batch_norm`` is refused, as the JAX package cannot run
  it) and ``--trainer segan`` (SEGAN: the conv auto-encoder G for
  ``--g_type ae|dnn|lstm``, the WaveNet-style G for any other, the VBN
  conv D conditioned on the spliced input; ``--g_enc_depths``, ``--g_nl``,
  ``--bias_downconv``, ``--bias_deconv``, ``--bias_d_conv``,
  ``--init_l1_weight``; RMSProp, no clipping), on shuffled frame batches
  of ``--left_context``/``--right_context`` spliced frames, with a CV
  pass before the first epoch, an accept or a reject after each (a
  reject rolls the whole state back to the last checkpoint) and the staged learning-rate decay (``--keep_lr``,
  ``--start_decay_impr``, ``--end_decay_impr``, ``--decay_factor``,
  ``--min_epoches``);
* for every trainer: checkpoints and the ``.meta.json`` sidecar in the
  JAX format, so either package resumes or decodes the other's
  checkpoints; periodic snapshots (``--checkpoint_every_secs``, a newer
  one wins on resume); JSONL metrics and, with ``--tensorboard`` (the
  default), event files under ``save_dir/train`` and ``save_dir/eval``;
* ``--decode`` for every trainer: G forward (batch-1 over each
  utterance's frames for the frame trainers, BatchNorm and BnLstm on the
  checkpoint's running statistics, SEGAN's G with z = 0), CMVN
  denormalisation, Kaldi feats.ark/feats.scp (``--compress``: compressed matrices, ``--text``:
  a text archive);
* ``--profile_dir``: a torch.profiler trace of the second iteration (the
  second epoch of the frame loop), as the JAX CLI traces with
  ``jax.profiler``.

``--lstm_impl auto|wavefront`` runs the hand-written kernels (the
wavefront stack for G, the single-layer kernels for D below 64 rows),
``pallas`` the single-layer kernels for every layer, ``scan`` the eager
cell under autograd (the f32 oracle). The CLI turns TF32 off, so f32 is
f32 on a card. ``--deconv_type`` is parsed and unused, as in JAX.

Data parallelism (``parallel``): ``--num_gpu=N`` spawns N ranks, one a
card (``cuda:r``; N above the cards raises), or N gloo ranks on the CPU
with ``--device=cpu``; ``--coordinator_address=host:port
--num_processes=N --process_id=i`` makes this process rank i, on
``cuda:{i % cards}``, and ignores ``--num_gpu``. The backend follows the
layout (``nccl`` where each rank has a card of its own, ``gloo`` where
ranks share one and on the CPU; the ``LOG:`` line names it). Each rank
trains on its row block of every global batch of ``--batch_size`` x N
rows, at the learning rates x N (the schedules too), with each update's
gradients and metrics averaged over the world and the batch statistics
of the global batch. Multi-process runs take the host-sharded views
(full global batches only) and the host feed; ``--num_gpu`` runs shard
every global batch and raise where its rows do not divide, as JAX's
mesh does. Only rank 0 writes checkpoints, snapshots, metrics and
TensorBoard files. ``--decode --num_gpu=N --decode_batch_size>1`` (a
sequence trainer) pads each batch's rows to a multiple of N, decodes a
block on each rank and gathers the rows to rank 0, which writes the
ark; any other decode in a multi-rank run runs on rank 0 alone.

    python -m rsrgan_tpu_torch.cli.train --trainer=gan_rnn \\
        --g_type=res_lstm_l --tr_list_file=tr.list --cv_list_file=cv.list \\
        --batch_size=16 --save_dir=exp/gan_rnn
    python -m rsrgan_tpu_torch.cli.train --trainer=dnn --g_type=dnn \\
        --left_context=5 --right_context=5 --batch_size=256 \\
        --tr_list_file=tr.list --cv_list_file=cv.list --save_dir=exp/dnn
    python -m rsrgan_tpu_torch.cli.train --trainer=segan --g_type=ae \\
        --left_context=3 --right_context=3 --batch_size=256 \\
        --disc_updates=1 --gen_updates=1 --tr_list_file=tr.list \\
        --cv_list_file=cv.list --save_dir=exp/segan
    python -m rsrgan_tpu_torch.cli.train --decode --trainer=gan_rnn \\
        --g_type=res_lstm_l --data_dir=DATA --test_list_file=test.list \\
        --save_dir=exp/gan_rnn --decode_batch_size=16
    python -m rsrgan_tpu_torch.cli.train --trainer=gan_rnn \\
        --g_type=res_lstm_l --batch_size=8 --num_gpu=4 ...
    python -m rsrgan_tpu_torch.cli.train ... \\
        --coordinator_address=host0:8476 --num_processes=2 --process_id=0
"""

from __future__ import annotations

import argparse
import datetime
import glob
import json
import os
import sys
import time
from typing import (Dict, Hashable, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from rsrgan_tpu_torch import spans
from rsrgan_tpu_torch.cli import (resolve_device, set_precision,
                                  str2bool)
from rsrgan_tpu_torch.data import (ArkWriter, FrameBatcher,
                                   HostShardedFrameBatches,
                                   HostShardedSequenceBatches,
                                   SequenceBatcher, StoreView,
                                   ThreadedPrefetcher, UtteranceStore,
                                   bucket_id, infer_batches, load_cmvn_npz,
                                   padded_length, read_list_file,
                                   splice_frames_np)
from rsrgan_tpu_torch.data.device_feed import (DeviceFeed,
                                               RotatingDeviceFeed,
                                               table_bytes)
from rsrgan_tpu_torch.models import (get_discriminator, get_generator,
                                     load_collections, load_flax_params)
from rsrgan_tpu_torch.models.segan import (SeganAEGenerator,
                                           SeganDiscriminator,
                                           SeganWaveGenerator)
from rsrgan_tpu_torch.parallel import (current_world, gather_rows,
                                       initialize, is_coordinator, launch,
                                       make_world, replicate, shard_batch,
                                       shutdown)
from rsrgan_tpu_torch.training import (GanTrainer, ImprovementTracker,
                                       MseTrainer, SeganTrainer,
                                       exponential_decay,
                                       load_checkpoint, load_generator_state,
                                       load_newest_state,
                                       periodic_snapshot_path,
                                       read_checkpoint_meta, save_checkpoint,
                                       save_periodic_snapshot, staged_decay,
                                       state_tree)
from rsrgan_tpu_torch.training.tensorboard import EventFileWriter

GAN_METRICS = ("d_rl_loss", "d_fk_loss", "d_loss", "g_adv_loss",
               "g_mse_loss", "g_l2_loss", "g_loss")
MSE_METRICS = ("g_mse_loss", "g_l2_loss", "g_loss")
SEGAN_METRICS = ("d_rl_loss", "d_fk_loss", "d_loss", "g_adv_loss",
                 "g_l1_loss", "g_loss")
SEQUENCE_TRAINERS = ("gan_rnn", "rnn")


def log(msg: str) -> None:
    """Print on the coordinator (every rank runs the same loop)."""
    if is_coordinator():
        print(msg)
        sys.stdout.flush()


def model_name(args) -> str:
    return {"gan_rnn": "GAN_RNN", "gan_dnn": "GAN", "rnn": "RNNTrainer",
            "dnn": "DNNTrainer", "segan": "SEGAN"}[args.trainer]


def resolve_lstm_impl(args) -> str:
    """'auto' and 'wavefront' run the wavefront kernel where the wiring
    allows it, 'pallas' the single-layer kernels, 'scan' the eager cell.
    On the CPU each kernel wrapper runs its plain twin."""
    return "wavefront" if args.lstm_impl == "auto" else args.lstm_impl


def validate_checkpoint_compat(args, name: str) -> None:
    """Fail legibly when the decode flags contradict the checkpoint's
    .meta.json sidecar (a wrong --g_type between the shape-identical
    res_lstm_l and res_lstm_base trees would silently decode garbage)."""
    meta = read_checkpoint_meta(args.save_dir, name)
    if meta is None:
        # a wrong --trainer looks for the wrong sidecar filename; fall back
        # to whatever trainer's sidecar IS in the directory
        others = sorted(glob.glob(os.path.join(args.save_dir,
                                               "*.meta.json")))
        if not others:
            return
        with open(others[0]) as f:
            meta = json.load(f)
    mismatches = []
    for key, got in [("trainer", args.trainer), ("g_type", args.g_type),
                     ("input_dim", args.input_dim),
                     ("output_dim", args.output_dim),
                     ("left_context", args.left_context),
                     ("right_context", args.right_context)]:
        want = meta.get(key)
        if want is not None and want != got:
            mismatches.append(f"--{key}={got} vs trained {key}={want}")
    if mismatches:
        raise SystemExit(
            f"checkpoint config mismatch in {args.save_dir}: "
            + "; ".join(mismatches)
            + " (from the checkpoint's .meta.json sidecar)")


def sharded_decode(args) -> bool:
    """Whether a decode spreads its batches over the ranks: batched
    decode of a sequence trainer, as JAX decodes over a mesh only there."""
    return args.trainer in SEQUENCE_TRAINERS and args.decode_batch_size > 1


def run_decode(args) -> int:
    """G forward over the test store, denormalised, into a Kaldi ark. In
    a multi-rank world a sharded decode (``sharded_decode``) pads each
    batch's rows to a multiple of the world, runs each rank's block and
    gathers the rows on every rank; rank 0 writes. Any other decode runs
    on rank 0 alone."""
    world = current_world()
    sharded = world.world > 1 and sharded_decode(args)
    if world.world > 1 and not sharded and world.rank != 0:
        return 0
    device = resolve_device(args.device)
    compute_dtype = torch.bfloat16 if args.bf16 else torch.float32
    name = model_name(args)
    validate_checkpoint_compat(args, name)
    sequence = args.trainer in SEQUENCE_TRAINERS
    if args.trainer == "segan":   # its infer_step: G with z = 0
        gen = segan_generator(args)
    else:
        gen = get_generator(args.g_type, input_dim=args.input_dim,
                            output_dim=args.output_dim,
                            left_context=args.left_context,
                            right_context=args.right_context,
                            batch_norm=args.batch_norm,
                            compute_dtype=compute_dtype,
                            lstm_impl=resolve_lstm_impl(args))
    found = load_generator_state(args.save_dir, name, args.moving_average)
    if found is None:
        log("[!] Load failed. Checkpoint not found. Exit now.")
        return 1
    params, extra = found
    load_flax_params(gen, params)
    load_collections(gen, extra)
    gen = gen.to(device).eval()
    log("[*] Load SUCCESS")

    test_store = UtteranceStore(read_list_file(args.test_list_file))
    cmvn_filename = os.path.join(args.data_dir, "train_cmvn.npz")
    if not os.path.isfile(cmvn_filename):
        log(f"{cmvn_filename} not exist, exit now.")
        return 1
    _, labels_cmvn = load_cmvn_npz(cmvn_filename)

    out_dir = os.path.join(args.save_dir, "test")
    os.makedirs(out_dir, exist_ok=True)
    ark_path = os.path.join(out_dir, "feats.ark")

    @torch.no_grad()
    def infer(inputs: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        if sharded:
            inputs, lengths = shard_batch(world, (inputs, lengths))
        if device.type == "cuda":
            # the two uploads from pageable memory and the read back
            spans.count("host_wait", 3)
        x = torch.from_numpy(inputs).to(device)
        out = (gen(x, torch.from_numpy(lengths).to(device)) if sequence
               else gen(x))
        return gather_rows(world, out.float()).cpu().numpy()

    start = datetime.datetime.now()
    writer = (ArkWriter(os.path.join(out_dir, "feats.scp"),
                        compress=args.compress, text=args.text)
              if is_coordinator() else None)
    try:
        if sequence and args.decode_batch_size > 1:
            _decode_batched(args, test_store, infer, labels_cmvn, writer,
                            ark_path, row_quant=world.world if sharded
                            else 1)
        else:
            num_batch = len(test_store)
            for i, batch in enumerate(infer_batches(test_store,
                                                    args.left_context,
                                                    args.right_context)):
                if sequence:
                    act = infer(batch.inputs, batch.lengths)[0]
                else:   # the utterance's frames, one batch of T_pad rows
                    act = infer(batch.inputs[0], batch.lengths)
                act = act[:int(batch.lengths[0])]
                writer.write_next_utt(ark_path, batch.utt_ids[0],
                                      labels_cmvn.denormalize(act))
                log(f"[{i + 1}/{num_batch}] Write inferred "
                    f"{batch.utt_ids[0]} to {ark_path}")
    finally:
        if writer is not None:
            writer.close()
    took = (datetime.datetime.now() - start).total_seconds()
    frames = int(test_store.lengths.sum())
    log(f"Decoding time is {took}s ({frames} frames, "
        f"{frames / max(took, 1e-9):.0f} frames/s on {device})")
    return 0


def _decode_batched(args, test_store, infer, labels_cmvn, writer,
                    ark_path, row_quant: int = 1) -> None:
    """Batched enhancement: group utterances by padded length (128-frame
    quantization), run B at a time, write results back in scp order
    (``writer`` None: nothing is written). ``row_quant``: each batch's
    rows are rounded up to a multiple of it with zero rows of full
    length (their outputs are dropped), so that they divide over the
    ranks."""
    B = args.decode_batch_size
    with spans.span("decode.pass"):
        lengths = test_store.lengths
        with spans.span("decode.order"):
            pad = [int(-(-l // 128) * 128) for l in lengths]
            order = sorted(range(len(test_store)),
                           key=lambda i: (pad[i], i))
        splice = args.left_context + 1 + args.right_context
        results = {}
        idx = 0
        while idx < len(order):
            with spans.span("decode.batch"):
                t_pad = pad[order[idx]]
                group = []
                while (idx < len(order) and len(group) < B
                       and pad[order[idx]] == t_pad):
                    group.append(order[idx])
                    idx += 1
                with spans.span("decode.assemble"):
                    rows = -(-len(group) // row_quant) * row_quant
                    x = np.zeros(
                        (rows, t_pad, test_store.input_dim * splice),
                        np.float32)
                    lens = np.full((rows,), t_pad, np.int32)
                    for row, i in enumerate(group):
                        feats = splice_frames_np(
                            np.asarray(test_store.inputs(i)),
                            args.left_context, args.right_context)
                        x[row, :feats.shape[0]] = feats
                        lens[row] = feats.shape[0]
                act = infer(x, lens)
                with spans.span("decode.denormalize"):
                    for row, i in enumerate(group):
                        results[i] = labels_cmvn.denormalize(
                            act[row, :lens[row]])
                # the batch's buffers (megabytes, whose release takes a
                # fraction of a ms) go with the batch, inside its span
                del x, act
        if writer is not None:
            with spans.span("decode.write"):
                for i in range(len(test_store)):
                    # each utterance's rows freed once written
                    writer.write_next_utt(ark_path, test_store.utt_ids[i],
                                          results.pop(i))
        log(f"Wrote {len(order)} utterances (batched decode, B={B})")


def ckpt_meta(args) -> dict:
    """The model-config sidecar saved next to checkpoints (as the JAX
    CLI writes it)."""
    return {"trainer": args.trainer, "g_type": args.g_type,
            "input_dim": args.input_dim, "output_dim": args.output_dim,
            "left_context": args.left_context,
            "right_context": args.right_context,
            # gan_dnn's D is always conditioned
            "d_conditioned": (args.trainer == "gan_dnn"
                              or bool(args.d_conditioned))}


def _fmt(metrics: dict, keys) -> str:
    return ", ".join(f"{k} = {float(metrics[k]):.5f}" for k in keys)


def _avg(accum: list) -> dict:
    """Per-step mean of the metrics, read back from the device in one
    copy and averaged in float64, as the JAX CLI averages them."""
    keys = list(accum[0])
    vals = torch.stack([torch.stack([torch.as_tensor(m[k]).float()
                                     for k in keys]) for m in accum]).cpu()
    return {k: float(v)
            for k, v in zip(keys, vals.double().mean(0).tolist())}


class MetricsWriter:
    """The JAX CLI's metrics sink: ``metrics_{split}.jsonl``, one line per
    iteration, and with ``tensorboard`` the same scalars as TensorBoard
    event files under ``save_dir/{split}``; on the coordinator only."""

    def __init__(self, save_dir: str, split: str, tensorboard: bool):
        self.enabled = is_coordinator()
        self.path = os.path.join(save_dir, f"metrics_{split}.jsonl")
        self._tb = None
        if self.enabled:
            os.makedirs(save_dir, exist_ok=True)
            if tensorboard:
                self._tb = EventFileWriter(os.path.join(save_dir, split))

    def write(self, iteration: int, metrics: dict) -> None:
        if not self.enabled:
            return
        scalars = {k: float(v) for k, v in metrics.items()}
        with open(self.path, "a") as f:
            f.write(json.dumps({"iteration": iteration, **scalars}) + "\n")
        if self._tb is not None:
            self._tb.add_scalars(iteration, scalars)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


class PeriodicSnapshotter:
    """--checkpoint_every_secs: a crash-recovery snapshot of the whole
    state, ``{name}.periodic.ckpt``, at most once per ``every_secs``
    (checked after each update); off at 0 and off on every rank but the
    coordinator."""

    def __init__(self, save_dir: str, name: str, every_secs: float):
        self.save_dir, self.name = save_dir, name
        self.every = every_secs if is_coordinator() else 0.0
        self._last = time.monotonic()

    def maybe(self, state) -> None:
        if self.every <= 0 or time.monotonic() - self._last < self.every:
            return
        save_periodic_snapshot(self.save_dir, self.name, state_tree(state))
        self._last = time.monotonic()
        log(f"Periodic snapshot saved ({self.name}.periodic.ckpt)")

    def invalidate(self) -> None:
        """Drop the snapshot when the live state is rolled back: a
        snapshot of the rejected trajectory must not win on resume."""
        path = periodic_snapshot_path(self.save_dir, self.name)
        if is_coordinator() and os.path.isfile(path):
            os.remove(path)


class Profiler:
    """--profile_dir: a torch.profiler trace of the JAX CLI's iteration
    (the second of the sequence loop, the second epoch of the frame
    loop), written by ``tensorboard_trace_handler``; view it in
    TensorBoard or Perfetto. CUDA activities are traced where the device
    is a card. Only the coordinator traces."""

    def __init__(self, profile_dir: Optional[str], device: torch.device):
        self.dir = profile_dir if is_coordinator() else None
        self.device = device
        self._prof = None

    def start(self) -> None:
        if self.dir and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    self.dir))
            self._prof.start()

    def stop(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self._prof = None
            log(f"Wrote profiler trace to {self.dir}")


def restore_state(args, name: str, state) -> Tuple[Optional[str], str]:
    """Restore the latest accepted checkpoint into ``state``; with
    periodic snapshots on, a newer snapshot wins (crash recovery).
    Returns (the file restored or None, its kind). Every rank restores
    the same files; then ``replicate_state``."""
    if args.checkpoint_every_secs > 0:
        return load_newest_state(args.save_dir, name, state)
    return load_checkpoint(args.save_dir, name, state), "checkpoint"


def replicate_state(state) -> None:
    """Every tensor of a trainer's state set to rank 0's (a no-op in one
    process)."""
    nets = (state.g, state.d) if hasattr(state, "g") else (state.net,)
    for net in nets:
        replicate(current_world(), net.tensors())


def save_state(args, name: str, state, step: int) -> None:
    """The accepted checkpoint, written by the coordinator alone."""
    if is_coordinator():
        save_checkpoint(args.save_dir, name, state_tree(state), step,
                        meta=ckpt_meta(args))


def spliced_width(args) -> int:
    """One spliced input row: ``--input_dim`` times the context's frames."""
    return args.input_dim * (args.left_context + 1 + args.right_context)


def segan_depths(args) -> Tuple[int, ...]:
    """--g_enc_depths: G's encoder depths, and D's."""
    return tuple(int(d) for d in args.g_enc_depths.split(","))


def segan_generator(args, generator: Optional[torch.Generator] = None):
    """SEGAN's G from the flags, as the JAX CLI's ``build_trainer`` builds
    it: ``--g_type`` ae, dnn or lstm (run_segan.sh: ae) the auto-encoder
    with ``--g_enc_depths``, ``--g_nl``, ``--bias_deconv`` and
    ``--bias_downconv``; any other the WaveNet-style G."""
    if args.g_type in ("ae", "dnn", "lstm"):
        return SeganAEGenerator(
            spliced_width(args), args.output_dim,
            enc_depths=segan_depths(args), do_prelu=args.g_nl == "prelu",
            bias_deconv=args.bias_deconv, bias_downconv=args.bias_downconv,
            generator=generator)
    return SeganWaveGenerator(spliced_width(args), args.output_dim,
                              generator=generator)


def build_trainer(args, device, compute_dtype):
    """The trainer of ``--trainer`` (the JAX CLI's ``build_trainer``), its
    nets on ``device``: the LSGANs (``gan_rnn``: SGD for D, each tensor
    clipped to 15; ``gan_dnn``: frame mode, Adam for both, no clipping, D
    conditioned), the MSE trainers (``rnn``: clipped to 15; ``dnn``:
    frame mode, no clipping) or SEGAN (RMSProp for both, no clipping; D
    sees the spliced input beside its target, ``--bias_d_conv``). Weights
    are drawn from ``--seed``."""
    gen = torch.Generator().manual_seed(args.seed)
    if args.trainer == "segan":
        g = segan_generator(args, gen)
        d = SeganDiscriminator(spliced_width(args) + args.output_dim,
                               num_fmaps=segan_depths(args),
                               bias_conv=args.bias_d_conv, generator=gen)
        return SeganTrainer(g.to(device), d.to(device),
                            disc_updates=args.disc_updates,
                            gen_updates=args.gen_updates)
    impl = resolve_lstm_impl(args)
    # --keep_prob drops out in G and in D, as the JAX CLI passes it to both
    g = get_generator(args.g_type, input_dim=args.input_dim,
                      output_dim=args.output_dim,
                      left_context=args.left_context,
                      right_context=args.right_context,
                      keep_prob=args.keep_prob, batch_norm=args.batch_norm,
                      compute_dtype=compute_dtype, lstm_impl=impl,
                      generator=gen).to(device)
    if args.trainer in ("rnn", "dnn"):
        trainer = MseTrainer(
            g, output_dim=args.output_dim, l2_scale=args.l2_scale,
            max_grad_norm=15.0 if args.trainer == "rnn" else None,
            sequence_mode=args.trainer == "rnn")
    elif args.trainer == "gan_dnn":
        # D sees the center input frame beside its target
        d = get_discriminator("dnn", input_dim=args.input_dim
                              + args.output_dim, keep_prob=args.keep_prob,
                              generator=gen)
        trainer = GanTrainer(g, d.to(device), output_dim=args.output_dim,
                             input_dim=args.input_dim,
                             left_context=args.left_context,
                             disc_updates=args.disc_updates,
                             gen_updates=args.gen_updates,
                             l2_scale=args.l2_scale, max_grad_norm=None,
                             g_optimizer="adam", d_optimizer="adam",
                             d_conditioned=True, frame_mode=True)
    else:
        # a conditioned D sees the center input frame beside its target
        d_in = args.output_dim + (args.input_dim if args.d_conditioned
                                  else 0)
        d = get_discriminator("lstm", input_dim=d_in,
                              keep_prob=args.keep_prob,
                              compute_dtype=compute_dtype, lstm_impl=impl,
                              generator=gen)
        trainer = GanTrainer(g, d.to(device), output_dim=args.output_dim,
                             input_dim=args.input_dim,
                             left_context=args.left_context,
                             disc_updates=args.disc_updates,
                             gen_updates=args.gen_updates,
                             l2_scale=args.l2_scale, max_grad_norm=15.0,
                             g_optimizer="adam", d_optimizer="sgd",
                             d_conditioned=args.d_conditioned)
    # the dropout masks' streams, apart from D's input noise (seed + 1)
    trainer.seed_dropout(args.seed + 2, device)
    return trainer


def log_variables(state) -> None:
    """Parameter counts (the JAX CLI's ``show_all_variables``)."""
    def count(net):
        return sum(p.numel() for p in net.params().values())

    if hasattr(state, "g"):
        log(f"G variables: {count(state.g) / 1e6:.2f}M params; "
            f"D variables: {count(state.d) / 1e6:.2f}M params")
    else:
        log(f"G variables: {count(state.net) / 1e6:.2f}M params")


# What the device feed's default budget leaves free on the card for the
# model, its optimizer state and the step's working set: the flagship
# step's peak allocation at B=64, T=600 (chip_smoke.py's feed phase,
# ``step_peak_bytes``) with headroom.
FEED_RESERVE_BYTES = 8 * 1024 ** 3


class FeedPlan(NamedTuple):
    """Resolved device-feed configuration (decide_device_feed)."""
    dtype: torch.dtype
    rotate: bool
    budget: int


def default_feed_budget(device: torch.device) -> int:
    """Bytes the feed's tables may take: the device's memory (the host's
    for the CPU) less ``FEED_RESERVE_BYTES``."""
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return total - FEED_RESERVE_BYTES


def decide_device_feed(args, tr_store, cv_store,
                       device: torch.device) -> Optional[FeedPlan]:
    """Resolve --device_feed/--device_feed_dtype to a FeedPlan, or None for
    the host feed (the JAX CLI's rule).

    The gathered path covers the sequence trainers in a single process
    and in a ``--num_gpu`` world (each rank holds the whole tables on its
    own card: the budget is per card), except the graph-fed GAN
    (--same_batch=false); it and multi-process runs keep the host feed.
    ``auto`` turns it on where the run's device is a card, ``on`` on any
    device. Tables over the budget (RSRGAN_FEED_HBM_BUDGET, bytes;
    default ``default_feed_budget``) drop to bfloat16, and bfloat16 tables
    over it rotate resident shards (RotatingDeviceFeed).
    """
    if args.device_feed == "off":
        return None
    eligible = (args.trainer in ("gan_rnn", "rnn")
                and not args.coordinator_address
                and (args.trainer != "gan_rnn" or args.same_batch))
    if not eligible:
        if args.device_feed == "on":
            log("NOTE: --device_feed=on ignored (multi-host/graph-fed "
                "runs use the host feed)")
        return None
    if args.device_feed == "auto" and device.type != "cuda":
        return None
    budget = float(os.environ.get("RSRGAN_FEED_HBM_BUDGET",
                                  default_feed_budget(device)))
    f32_bytes = table_bytes(tr_store, 4) + table_bytes(cv_store, 4)
    if args.device_feed_dtype == "float32":
        dtype = torch.float32
    elif args.device_feed_dtype == "bfloat16":
        dtype = torch.bfloat16
    elif f32_bytes <= budget:
        dtype = torch.float32
    else:
        log(f"[*] device feed: f32 tables ({f32_bytes / 1e9:.1f} GB) exceed "
            f"the device budget ({budget / 1e9:.1f} GB); using bfloat16 "
            "tables")
        dtype = torch.bfloat16
    itemsize = torch.empty((), dtype=dtype).element_size()
    need = table_bytes(tr_store, itemsize) + table_bytes(cv_store, itemsize)
    rotate = need > budget
    if rotate:
        log(f"[*] device feed: {str(dtype).split('.')[-1]} tables "
            f"({need / 1e9:.1f} GB) exceed the device budget "
            f"({budget / 1e9:.1f} GB); rotating resident shards")
    return FeedPlan(dtype, rotate, int(budget))


def plan_key(lengths: np.ndarray, num_buckets: int) -> Tuple[int, int]:
    """(t_pad, rows) of a batch plan: the shape its batch is padded to."""
    mx = int(lengths.max())
    return padded_length(bucket_id(mx, num_buckets), mx, num_buckets), \
        len(lengths)


def dispatch_order(keys: Sequence[Hashable],
                   steps_per_call: int) -> List[int]:
    """Positions of an epoch's batches in the order the JAX CLI updates on
    them: batches wait by shape key; a key's group runs (in arrival order)
    when ``steps_per_call`` are waiting; what is left runs at the end,
    group by group in the order the waiting keys were inserted. The JAX
    CLI dispatches a full group as one multi-step scan, the port as that
    many steps; the optimisation order is the same."""
    pending: Dict[Hashable, List[int]] = {}
    order: List[int] = []
    for i, key in enumerate(keys):
        pending.setdefault(key, []).append(i)
        if len(pending[key]) == steps_per_call:
            order.extend(pending.pop(key))
    for group in pending.values():
        order.extend(group)
    return order


def rank_plans(batcher, view=None) -> List[Tuple[Sequence[int], int]]:
    """One epoch of ``batcher``'s plans as this rank trains them:
    (its indices, the global batch's t_pad). In one process every plan;
    in a ``--num_gpu`` world this rank's row block of every plan (rows
    that do not divide over the world raise, as on JAX's mesh); in a
    multi-process run ``view``'s (``HostShardedSequenceBatches``: full
    global batches only)."""
    if view is not None:
        return list(view.iter_plans())
    world = current_world()
    return [(shard_batch(world, ix), batcher.plan_t_pad(ix))
            for ix in batcher.iter_index_batches()]


def dispatch_plans(plan_lists, steps_per_call: int
                   ) -> List[Tuple[Sequence[int], int]]:
    """The (indices, t_pad) plans of ``plan_lists`` (epochs of
    ``rank_plans``, in turn) in dispatch order, keyed by their shape
    (t_pad, rows)."""
    plans = [p for pl in plan_lists for p in pl]
    keys = [(t_pad, len(ix)) for ix, t_pad in plans]
    return [plans[i] for i in dispatch_order(keys, steps_per_call)]


def plan_to_device(starts: np.ndarray, lengths: np.ndarray,
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One [B] plan to the device through a small pinned buffer, without
    waiting for the copy (the caching host allocator keeps the buffer
    until the copy has read it)."""
    with spans.span("feed.to_device"):
        host = torch.from_numpy(np.stack([starts, lengths]).astype(np.int32))
        if device.type == "cuda":
            host = host.pin_memory()
        dev = host.to(device, non_blocking=True)
        return dev[0], dev[1]


def world_total(count: int) -> int:
    """A count summed over the ranks (the count itself in one process)."""
    world = current_world()
    if world.world == 1:
        return count
    total = torch.tensor([float(count)], dtype=torch.float64,
                         device=world.device)
    return int(world.all_reduce_sum_(total).item())


def make_hparams(args, num_devices: int = 1) -> Dict[str, float]:
    """The steps' assignable scalars at their initial values (the JAX
    CLI's ``make_hparams``): the learning rates x the world."""
    return {"g_lr": args.g_learning_rate * num_devices,
            "d_lr": args.d_learning_rate * num_devices,
            "mse_lambda": args.init_mse_weight,
            "l1_lambda": args.init_l1_weight,
            "disc_noise_std": args.init_disc_noise_std,
            "d_real": 1.0, "d_fake": 0.0}


def run_sequence_training(args) -> int:
    """The sequence loop of the JAX CLI (``run_sequence_training``) for
    --trainer=gan_rnn and --trainer=rnn: the device feed (resident or
    rotating tables), the graph-fed loop (gan_rnn with
    --same_batch=false) or the host feed. The MSE trainer takes
    ``hp["g_lr"]`` as its learning rate. In a data-parallel world each
    rank trains on its rows of every global batch (``rank_plans``)."""
    device = resolve_device(args.device)
    world = current_world()
    num_devices = world.world
    compute_dtype = torch.bfloat16 if args.bf16 else torch.float32
    trainer = build_trainer(args, device, compute_dtype)
    is_gan = args.trainer == "gan_rnn"
    metric_keys = GAN_METRICS if is_gan else MSE_METRICS
    name = model_name(args)

    tr_store = UtteranceStore(read_list_file(args.tr_list_file))
    cv_store = UtteranceStore(read_list_file(args.cv_list_file))
    global_batch = args.batch_size * num_devices

    def make_batcher(store, shuffle):
        b = SequenceBatcher(store, global_batch, args.left_context,
                            args.right_context, shuffle=shuffle,
                            seed=args.seed)
        if b.num_batches() == 0:
            # small sets: keep the ragged batches of partial buckets
            b = SequenceBatcher(store, global_batch, args.left_context,
                                args.right_context, shuffle=shuffle,
                                drop_remainder=False, seed=args.seed)
        return b

    tr_batches = make_batcher(tr_store, True)
    cv_batches = make_batcher(cv_store, False)
    tr_view = cv_view = None
    if args.coordinator_address:
        # the shared global plan; this process builds only its rows
        tr_view = HostShardedSequenceBatches(tr_batches, world.rank,
                                             num_devices)
        cv_view = HostShardedSequenceBatches(cv_batches, world.rank,
                                             num_devices)
    min_iters, max_iters = args.min_epoches, args.max_epoches
    log(f"LOG: #train_batch = {(tr_view or tr_batches).num_batches()}, "
        f"#valid_batch = {(cv_view or cv_batches).num_batches()}\n"
        f"LOG: #min_iters = {min_iters}, #max_iters = {max_iters}")

    state = trainer.init_state()
    restored, restore_src = restore_state(args, name, state)
    log(f"[*] Load SUCCESS ({restore_src})" if restored
        else "[!] Begin a new model.")
    replicate_state(state)
    snapper = PeriodicSnapshotter(args.save_dir, name,
                                  args.checkpoint_every_secs)
    log_variables(state)
    hp = make_hparams(args, num_devices)
    tracker = ImprovementTracker(args.end_improve)
    noise = torch.Generator(device=device).manual_seed(args.seed + 1)
    tr_writer = MetricsWriter(args.save_dir, "train", args.tensorboard)
    cv_writer = MetricsWriter(args.save_dir, "eval", args.tensorboard)
    steps_per_call = max(1, args.steps_per_call)
    left, right = args.left_context, args.right_context
    profiler = Profiler(args.profile_dir, device)

    # the two trainers' steps on one batch, or on a plan in the resident
    # tables (hp is read at each call: the schedules change it)
    def train_step(x, y, lens):
        if is_gan:
            return trainer.train_step(state, x, y, lens, hp, noise)
        return trainer.train_step(state, x, y, lens, hp["g_lr"])

    def eval_step(x, y, lens):
        if is_gan:
            return trainer.eval_step(state, x, y, lens, hp, noise)
        return trainer.eval_step(state, x, y, lens)

    def gathered(fn, feed, st, le, t_pad, *lr):
        tables = (feed.inputs_tbl, feed.labels_tbl, st, le)
        if is_gan:
            return fn(state, *tables, hp, noise, t_pad, left, right)
        return fn(state, *tables, *lr, t_pad, left, right)

    feed_plan = decide_device_feed(args, tr_store, cv_store, device)
    feed_tr = feed_cv = None
    rotating = False
    shard_batchers = visits = None
    if feed_plan is not None:
        t0 = time.monotonic()
        dtype_name = str(feed_plan.dtype).split(".")[-1]
        feed_cv = DeviceFeed(cv_store, feed_plan.dtype, device)
        if feed_plan.rotate:
            itemsize = torch.empty((), dtype=feed_plan.dtype).element_size()
            tr_budget = feed_plan.budget - table_bytes(cv_store, itemsize)
            feed_tr = RotatingDeviceFeed(
                tr_store, feed_plan.dtype, tr_budget, device,
                seed=args.seed, prefetch=args.feed_prefetch)
            rotating = True
            shard_batchers = [make_batcher(StoreView(tr_store, s), True)
                              for s in feed_tr.shards]
            visits = feed_tr.schedule(max_iters, args.feed_rotation_block,
                                      seed=args.seed)
            log(f"[*] device feed: rotating {feed_tr.num_shards} shards "
                f"(<= {feed_tr.max_rows} frames each, "
                f"{feed_tr.num_bytes / 1e9:.2f} GB of {dtype_name} "
                f"buffers), {len(visits)} residencies x "
                f"<= {args.feed_rotation_block} passes"
                f"{', async prefetch' if args.feed_prefetch else ''}")
        else:
            feed_tr = DeviceFeed(tr_store, feed_plan.dtype, device)
            log(f"[*] device feed: "
                f"{(feed_tr.num_bytes + feed_cv.num_bytes) / 1e9:.2f} GB "
                f"resident ({dtype_name} tables) uploaded in "
                f"{time.monotonic() - t0:.1f} s")

    # Rotation makes one loop iteration a shard residency (block passes
    # over one shard); schedules and stop conditions then advance by
    # effective epochs = completed passes / num_shards, so lr decay and
    # min/max-epoch semantics stay in corpus-epoch units.
    n_iterations = len(visits) if rotating else max_iters
    min_stop_iters = min_iters
    if rotating:
        cum = 0
        min_stop_iters = n_iterations
        for i, (_, p) in enumerate(visits):
            cum += p
            if cum >= min_iters * feed_tr.num_shards:
                min_stop_iters = i + 1
                break
    eff_epoch = 0.0

    def on_device(batch):
        return (torch.from_numpy(batch.inputs).to(device),
                torch.from_numpy(batch.labels).to(device),
                torch.from_numpy(batch.lengths).to(device))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for iteration in range(n_iterations):
        if iteration == 1:
            profiler.start()   # the steady-state second iteration
        start = datetime.datetime.now()
        tr_accum, cv_accum = [], []
        true_frames = 0
        if feed_tr is not None:
            if rotating:
                shard_k, n_passes = visits[iteration]
                feed_tr.ensure_resident(shard_k)
                if args.feed_prefetch and iteration + 1 < len(visits):
                    feed_tr.start_prefetch(visits[iteration + 1][0])
                batchers = [shard_batchers[shard_k]] * n_passes
                eff_epoch += n_passes / feed_tr.num_shards
            else:
                batchers = [tr_batches]
                eff_epoch += 1.0
            for indices, t_pad in dispatch_plans(
                    [rank_plans(b) for b in batchers], steps_per_call):
                st, le = feed_tr.plan(indices)
                true_frames += int(le.sum())
                tr_accum.append(gathered(
                    trainer.train_step_gathered, feed_tr,
                    *plan_to_device(st, le, device), t_pad, hp["g_lr"]))
                snapper.maybe(state)
            tr_m = _avg(tr_accum) if tr_accum else None
        elif is_gan and not args.same_batch:
            # graph-fed: D and G steps on successive minibatches of the
            # stream, until it runs out (wherever that falls)
            d_accum, g_accum = [], []
            stream = iter(ThreadedPrefetcher(
                (tr_batches._make_batch(ix, t_pad) for ix, t_pad in
                 rank_plans(tr_batches, tr_view)), 32))
            try:
                while True:
                    for _ in range(args.disc_updates):
                        batch = next(stream)
                        true_frames += int(batch.lengths.sum())
                        d_accum.append(trainer.d_step(
                            state, *on_device(batch), hp, noise))
                    for _ in range(args.gen_updates):
                        batch = next(stream)
                        true_frames += int(batch.lengths.sum())
                        g_accum.append(trainer.g_step(
                            state, *on_device(batch), hp, noise))
                    snapper.maybe(state)
            except StopIteration:
                pass
            tr_accum = d_accum + g_accum
            tr_m = ({**_avg(d_accum), **_avg(g_accum)}
                    if d_accum and g_accum else None)
        else:
            plans = dispatch_plans([rank_plans(tr_batches, tr_view)],
                                   steps_per_call)
            for batch in ThreadedPrefetcher(
                    (tr_batches._make_batch(ix, t_pad)
                     for ix, t_pad in plans), 32):
                true_frames += int(batch.lengths.sum())
                tr_accum.append(train_step(*on_device(batch)))
                snapper.maybe(state)
            tr_m = _avg(tr_accum) if tr_accum else None
        if tr_m is None:
            log("ERROR: empty train batch stream")
            return 1
        sync()   # _avg read the metrics back; the train section is done
        train_secs = (datetime.datetime.now() - start).total_seconds()
        true_frames = world_total(true_frames)
        if feed_cv is not None:
            for indices, t_pad in dispatch_plans([rank_plans(cv_batches)],
                                                 steps_per_call):
                st, le = feed_cv.plan(indices)
                cv_accum.append(gathered(
                    trainer.eval_step_gathered, feed_cv,
                    *plan_to_device(st, le, device), t_pad))
        else:
            plans = dispatch_plans([rank_plans(cv_batches, cv_view)],
                                   steps_per_call)
            for batch in ThreadedPrefetcher(
                    (cv_batches._make_batch(ix, t_pad)
                     for ix, t_pad in plans), 32):
                cv_accum.append(eval_step(*on_device(batch)))
        if not cv_accum:
            log("ERROR: empty cv batch stream")
            return 1
        cv_m = _avg(cv_accum)
        if not all(np.isfinite(v) for v in tr_m.values()):
            log(f"FATAL: non-finite training loss at iteration "
                f"{iteration + 1}: {tr_m} — stopping (last accepted "
                f"checkpoint is preserved).")
            return 2
        took = (datetime.datetime.now() - start).total_seconds()
        fps = true_frames / max(train_secs, 1e-9)
        rot_note = ""
        if rotating:
            rot_note = (f" [shard {visits[iteration][0]} x "
                        f"{visits[iteration][1]} passes, epoch "
                        f"{eff_epoch:.2f}, uploads {feed_tr.uploads} "
                        f"({feed_tr.upload_secs:.0f} s total)]")
        log(f"{iteration + 1}/{n_iterations} (INFO): d_learning_rate = "
            f"{hp['d_lr']:.5e}, g_learning_rate = {hp['g_lr']:.5e}, "
            f"time = {took / 3600.0:.3f} h\n"
            f"{iteration + 1}/{n_iterations} (SPEED): train_frames_per_sec "
            f"= {fps:.0f} (true frames through the cli/train loop, "
            f"{train_secs:.1f} s train section, {len(tr_accum)} steps on "
            f"{device}){rot_note}\n"
            f"{iteration + 1}/{n_iterations} (TRAIN AVG.LOSS): "
            f"{_fmt(tr_m, metric_keys)}\n"
            f"{iteration + 1}/{n_iterations} (CROSS AVG.LOSS): "
            f"{_fmt(cv_m, metric_keys)}")
        tr_row = {**tr_m, "train_frames_per_sec": fps,
                  "train_secs": train_secs, "train_steps": len(tr_accum),
                  "g_lr": hp["g_lr"], "d_lr": hp["d_lr"]}
        if rotating:
            tr_row["eff_epoch"] = eff_epoch
        tr_writer.write(iteration + 1, tr_row)
        cv_writer.write(iteration + 1, cv_m)
        profiler.stop()

        # the reference's staircase: epoch 1 at the initial values, epoch
        # k >= 2 at decay(k - 1) on completed epochs. Under rotation a
        # residency can end mid-epoch, so the count is of whole effective
        # epochs, and the initial values hold until the first completes.
        sched_t = int(eff_epoch) if rotating else iteration + 1
        if sched_t >= 1:
            hp["g_lr"] = exponential_decay(sched_t, num_devices, min_iters,
                                           args.g_learning_rate)
            hp["d_lr"] = exponential_decay(sched_t, num_devices, min_iters,
                                           args.d_learning_rate)
            hp["disc_noise_std"] = exponential_decay(
                sched_t, num_devices, min_iters, args.init_disc_noise_std,
                multiply_jobs=False)

        tracker.add(cv_m["g_loss"])
        if tracker.check(iteration):
            save_state(args, name, state, iteration + 1)
            log(f"Iteration {iteration + 1}: Nnet Accepted. "
                f"Save model SUCCESS.")
        else:
            log(f"Iteration {iteration + 1}: Nnet Rejected.")
        if tracker.should_stop(iteration, min_stop_iters):
            log(f"Iteration {iteration + 1}: Finished, too small relative "
                f"G improvement {tracker.rel_impr:g}")
            break
    tr_writer.close()
    cv_writer.close()
    log("Training Done.")
    return 0


def frame_train_step(trainer, state, x: np.ndarray, y: np.ndarray,
                     device: torch.device, hp: Dict[str, float], rand,
                     g_lr: float) -> Dict[str, torch.Tensor]:
    """One step of the frame loop on a host batch (this rank's rows):
    ``x`` and ``y`` to ``device`` (``feed.to_device``; two copies from
    pageable memory, each of which waits for the card's queue), then the
    trainer's step: SEGAN's with ``hp`` and ``rand``, the source of its z
    and D noise; the frame GAN's with ``hp``; the MSE trainer's at
    ``g_lr``. Returns the step's metrics (device scalars)."""
    with spans.span("feed.to_device"):
        if device.type != "cpu":
            spans.count("host_wait", 2)
        x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    if isinstance(trainer, SeganTrainer):
        return trainer.train_step(state, x, y, hp, rand)
    if isinstance(trainer, GanTrainer):
        return trainer.train_step(state, x, y, None, hp)
    return trainer.train_step(state, x, y, None, g_lr)


def run_frame_training(args) -> int:
    """The frame loop of the JAX CLI (``run_frame_training``) for
    --trainer=dnn, --trainer=gan_dnn and --trainer=segan, in f32:
    shuffled frame batches through a prefetch thread, a CV pass before the first epoch, then per
    epoch the train pass, the CV pass, and an accept (checkpoint) or a
    reject, which reloads the last checkpoint into the whole state
    (params, optimizer moments, EMA, batch statistics, step) and drops
    the periodic snapshot. The staged decay steps the MSE trainer's
    learning rate when the relative CV improvement falls below
    --start_decay_impr from epoch --keep_lr on; below --end_decay_impr the
    run stops, once --min_epoches have run. As in JAX, the frame GAN's
    and SEGAN's steps keep the initial hp and only the log shows the
    staged rate. SEGAN's state starts from the first train batch (D's VBN
    statistics); its steps draw z and D's noise from a generator seeded
    with --seed + 1, and each CV batch from one seeded with 0, as the JAX
    loop gives every CV batch ``PRNGKey(0)``. In a data-parallel world
    each rank trains on its rows of every global batch of --batch_size x
    the world, at the learning rates x the world; SEGAN's state starts
    from the whole first global batch on every rank."""
    device = resolve_device(args.device)
    world = current_world()
    num_devices = world.world
    trainer = build_trainer(args, device, torch.float32)
    is_gan = args.trainer == "gan_dnn"
    is_segan = args.trainer == "segan"
    metric_keys = (SEGAN_METRICS if is_segan
                   else GAN_METRICS if is_gan else MSE_METRICS)
    name = model_name(args)
    left, right = args.left_context, args.right_context

    tr_store = UtteranceStore(read_list_file(args.tr_list_file))
    cv_store = UtteranceStore(read_list_file(args.cv_list_file))
    global_batch = args.batch_size * num_devices
    tr_batches = FrameBatcher(tr_store, global_batch, left, right,
                              seed=args.seed)
    cv_batches = FrameBatcher(cv_store, global_batch, left, right,
                              shuffle=False, seed=args.seed)
    tr_view = cv_view = None
    if args.coordinator_address:
        tr_view = HostShardedFrameBatches(tr_batches, world.rank,
                                          num_devices)
        cv_view = HostShardedFrameBatches(cv_batches, world.rank,
                                          num_devices)
    log(f"LOG: #train_batch = {(tr_view or tr_batches).num_batches()}, "
        f"#valid_batch = {(cv_view or cv_batches).num_batches()}")
    # the JAX CLI draws its init example from the train batcher, which
    # takes the first permutation; the port takes it too, so that its
    # epochs see the JAX permutations (SEGAN's init needs the example)
    first = next(tr_batches.iter_index_batches(), None)

    if is_segan:
        state = trainer.init_state(torch.from_numpy(
            tr_batches._make_batch(first)[0]).to(device))
    else:
        state = trainer.init_state()
    restored, restore_src = restore_state(args, name, state)
    log(f"[*] Load SUCCESS ({restore_src})" if restored
        else "[!] Begin a new model.")
    replicate_state(state)
    snapper = PeriodicSnapshotter(args.save_dir, name,
                                  args.checkpoint_every_secs)
    log_variables(state)
    hp = make_hparams(args, num_devices)
    g_lr = hp["g_lr"]
    tr_writer = MetricsWriter(args.save_dir, "train", args.tensorboard)
    cv_writer = MetricsWriter(args.save_dir, "eval", args.tensorboard)
    profiler = Profiler(args.profile_dir, device)

    def on_device(x, y):
        return (torch.from_numpy(x).to(device),
                torch.from_numpy(y).to(device))

    def batches(batcher, view):
        """This rank's (inputs, labels) of every batch of an epoch."""
        plans = (view.iter_index_batches() if view is not None else
                 (shard_batch(world, sel)
                  for sel in batcher.iter_index_batches()))
        return (batcher._make_batch(sel) for sel in plans)

    def eval_epoch():
        accum = []
        for x, y in batches(cv_batches, cv_view):
            if is_segan:
                cv_rand = torch.Generator(device=device).manual_seed(0)
                accum.append(trainer.eval_step(state, *on_device(x, y), hp,
                                               cv_rand))
            elif is_gan:
                accum.append(trainer.eval_step(state, *on_device(x, y),
                                               None, hp))
            else:
                accum.append(trainer.eval_step(state, *on_device(x, y),
                                               None))
        return _avg(accum) if accum else None

    cv_m = eval_epoch()
    if cv_m is None:
        log("ERROR: empty cv batch stream")
        return 1
    log(f"CROSSVAL.LOSS PRERUN: {_fmt(cv_m, metric_keys)}")
    g_loss_prev = cv_m["g_loss"]
    decay_steps = 1
    rand = torch.Generator(device=device).manual_seed(args.seed + 1)

    for epoch in range(args.max_epoches):
        if epoch == 1:
            profiler.start()
        start = datetime.datetime.now()
        tr_accum = []
        for x, y in ThreadedPrefetcher(batches(tr_batches, tr_view), 32):
            tr_accum.append(frame_train_step(trainer, state, x, y, device,
                                             hp, rand, g_lr))
            snapper.maybe(state)
        if not tr_accum:
            log("ERROR: empty train batch stream")
            return 1
        tr_m = _avg(tr_accum)   # reads the metrics back: the pass is done
        train_secs = (datetime.datetime.now() - start).total_seconds()
        cv_m = eval_epoch()
        took = (datetime.datetime.now() - start).total_seconds()
        frames = len(tr_accum) * global_batch
        fps = frames / max(train_secs, 1e-9)
        log(f"Epoch {epoch + 1} (TRAIN AVG.LOSS): {_fmt(tr_m, metric_keys)},"
            f" learning_rate= {g_lr:.3e}\n"
            f"Epoch {epoch + 1} (CROSS AVG.LOSS): {_fmt(cv_m, metric_keys)},"
            f" TIME USED {took / 3600.0:.2f} h\n"
            f"Epoch {epoch + 1} (SPEED): train_frames_per_sec = {fps:.0f} "
            f"({train_secs:.1f} s train section, {len(tr_accum)} steps on "
            f"{device})")
        tr_writer.write(epoch + 1, {**tr_m, "train_frames_per_sec": fps,
                                    "train_secs": train_secs,
                                    "train_steps": len(tr_accum),
                                    "learning_rate": g_lr})
        cv_writer.write(epoch + 1, cv_m)
        profiler.stop()

        g_loss_new = cv_m["g_loss"]
        g_rel_impr = (g_loss_prev - g_loss_new) / g_loss_prev
        if g_loss_new < g_loss_prev:
            save_state(args, name, state, epoch + 1)
            log(f"Epoch {epoch + 1}: Nnet Accepted. Save model SUCCESS.")
            g_loss_prev = g_loss_new
        else:
            log(f"Epoch {epoch + 1}: Nnet Rejected.")
            if load_checkpoint(args.save_dir, name, state) is None:
                log("[!] Load failed. No checkpoint to restore. Exit now.")
                return 1
            replicate_state(state)
            snapper.invalidate()
            log("[*] Load previous model SUCCESS.")

        if g_rel_impr < args.start_decay_impr and \
                epoch + 1 >= args.keep_lr:
            g_lr = staged_decay(args.g_learning_rate * num_devices,
                                args.decay_factor, decay_steps)
            decay_steps += 1
        if g_rel_impr < args.end_decay_impr:
            if epoch < args.min_epoches:
                log(f"Epoch {epoch + 1}: We were supposed to finish, but we "
                    f"continue as min_epoches {args.min_epoches}")
                continue
            log(f"Epoch {epoch + 1}: Finished, too small relative G "
                f"improvement {g_rel_impr:g}")
            break
    tr_writer.close()
    cv_writer.close()
    log("Training Done.")
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags (same names and defaults) plus --device."""
    p = argparse.ArgumentParser(prog="rsrgan_tpu_torch.cli.train")
    p.add_argument("--trainer", default="gan_rnn",
                   choices=["gan_rnn", "gan_dnn", "rnn", "dnn", "segan"])
    p.add_argument("--decode", action="store_true", default=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train or decode on; 'cuda' fails "
                        "when no GPU is present (it never falls back to the "
                        "CPU)")
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--tr_list_file", type=str, default=None)
    p.add_argument("--cv_list_file", type=str, default=None)
    p.add_argument("--test_list_file", type=str, default=None)
    p.add_argument("--input_dim", type=int, default=257)
    p.add_argument("--output_dim", type=int, default=40)
    p.add_argument("--left_context", type=int, default=0)
    p.add_argument("--right_context", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--g_learning_rate", type=float, default=0.0003)
    p.add_argument("--d_learning_rate", type=float, default=0.001)
    p.add_argument("--min_epoches", type=int, default=25)
    p.add_argument("--max_epoches", type=int, default=30)
    p.add_argument("--end_improve", type=float, default=0.001)
    p.add_argument("--num_threads", type=int, default=8)
    p.add_argument("--save_dir", type=str, default="exp/gan_rnn")
    p.add_argument("--init_mse_weight", type=float, default=1.0)
    p.add_argument("--init_l1_weight", type=float, default=100.0)
    p.add_argument("--g_nl", default="leaky", choices=["leaky", "prelu"])
    p.add_argument("--bias_deconv", type=str2bool, nargs="?", const=True,
                   default=True)
    p.add_argument("--bias_downconv", type=str2bool, nargs="?", const=True,
                   default=False)
    p.add_argument("--deconv_type", default="deconv",
                   choices=["deconv", "nn_deconv"])
    p.add_argument("--g_enc_depths",
                   default="16,32,32,64,64,128,128,256,256,512,1024")
    p.add_argument("--g_type", type=str, default="lstm")
    p.add_argument("--disc_updates", type=int, default=1)
    p.add_argument("--gen_updates", type=int, default=2)
    p.add_argument("--batch_norm", type=str2bool, nargs="?", const=True,
                   default=False)
    p.add_argument("--keep_prob", type=float, default=1.0)
    p.add_argument("--init_disc_noise_std", type=float, default=0.0)
    p.add_argument("--l2_scale", type=float, default=0.00001)
    p.add_argument("--num_gpu", type=int, default=1)
    p.add_argument("--start_decay_impr", type=float, default=0.003)
    p.add_argument("--end_decay_impr", type=float, default=0.0005)
    p.add_argument("--keep_lr", type=int, default=3)
    p.add_argument("--decay_factor", type=float, default=0.5)
    p.add_argument("--compress", type=str2bool, nargs="?", const=True,
                   default=False)
    p.add_argument("--text", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="write decoded feats.ark as a Kaldi TEXT archive")
    p.add_argument("--coordinator_address", type=str, default="")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--checkpoint_every_secs", type=float, default=0.0)
    p.add_argument("--tensorboard", type=str2bool, nargs="?", const=True,
                   default=True)
    p.add_argument("--bf16", type=str2bool, nargs="?", const=True,
                   default=True,
                   help="bfloat16 matmul operands in the models (f32 "
                        "accumulation and state)")
    p.add_argument("--steps_per_call", type=int, default=8,
                   help="same-shape batches the JAX CLI groups into one "
                        "call; the port runs them as single steps in that "
                        "order (the update order of the JAX CLI)")
    p.add_argument("--device_feed", default="auto",
                   choices=["auto", "on", "off"],
                   help="the corpus resident on the device, batches "
                        "gathered there: auto = on where --device is a "
                        "card; budget RSRGAN_FEED_HBM_BUDGET (bytes)")
    p.add_argument("--device_feed_dtype", default="auto",
                   choices=["auto", "float32", "bfloat16"])
    p.add_argument("--feed_rotation_block", type=int, default=1)
    p.add_argument("--feed_prefetch", type=str2bool, nargs="?", const=True,
                   default=False)
    p.add_argument("--d_conditioned", type=str2bool, nargs="?", const=True,
                   default=False)
    p.add_argument("--same_batch", type=str2bool, nargs="?", const=True,
                   default=True)
    p.add_argument("--lstm_impl", default="auto",
                   choices=["auto", "scan", "pallas", "wavefront"],
                   help="LSTM recurrence: auto/wavefront (the wavefront "
                        "kernel for G, the single-layer kernels for D below "
                        "64 rows), pallas (the single-layer kernels), scan "
                        "(the eager cell); kernels run their plain twins on "
                        "the CPU")
    p.add_argument("--moving_average", type=str2bool, nargs="?", const=True,
                   default=False, help="decode with EMA shadow params")
    p.add_argument("--decode_batch_size", type=int, default=1,
                   help=">1: batched enhancement grouped by padded length")
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the second "
                        "iteration (frame loop: second epoch) here")
    p.add_argument("--bias_d_conv", type=str2bool, nargs="?", const=True,
                   default=True)
    for alias in ("min_epochs", "max_epochs"):
        p.add_argument(f"--{alias}", type=int, default=None)
    for alias in ("init_noise_std", "start_halving_impr",
                  "end_halving_impr", "halving_factor"):
        p.add_argument(f"--{alias}", type=float, default=None)
    return p


_FLAG_ALIASES = (
    ("min_epochs", "min_epoches"),
    ("max_epochs", "max_epoches"),
    ("init_noise_std", "init_disc_noise_std"),
    ("start_halving_impr", "start_decay_impr"),
    ("end_halving_impr", "end_decay_impr"),
    ("halving_factor", "decay_factor"),
)


def apply_flag_aliases(args) -> None:
    for alias, canonical in _FLAG_ALIASES:
        value = getattr(args, alias)
        if value is not None:
            setattr(args, canonical, value)


def parse_args(argv=None):
    """The flags (aliases applied) and the unknown ones."""
    args, unparsed = build_parser().parse_known_args(argv)
    apply_flag_aliases(args)
    return args, unparsed


def run(args) -> int:
    """Decode or train, as the flags say, in this process's world."""
    if args.decode:
        return run_decode(args)
    if args.trainer in SEQUENCE_TRAINERS:
        return run_sequence_training(args)
    return run_frame_training(args)   # dnn, gan_dnn, segan


def spawned_ranks(args) -> int:
    """The ranks ``--num_gpu`` spawns: N for training and for a sharded
    decode (``sharded_decode``), else 1 (JAX decodes over a mesh only
    there). On a card N may not exceed the cards."""
    if args.num_gpu <= 1 or args.coordinator_address or (
            args.decode and not sharded_decode(args)):
        return 1
    if resolve_device(args.device).type == "cuda" and \
            args.num_gpu > torch.cuda.device_count():
        raise ValueError(f"--num_gpu={args.num_gpu} but only "
                         f"{torch.cuda.device_count()} CUDA devices")
    return args.num_gpu


def run_rank(rank: int, world: int, address: str, args) -> int:
    """One rank of a data-parallel world: its device (``cuda:{rank %
    cards}``, or the CPU), the world joined at ``address``, then
    ``run``."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
    else:   # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    args.device = str(device)
    set_precision()
    initialize(address, world, rank, device)
    try:
        w = make_world(device)
        log(f"LOG: data-parallel world of {w.world} ranks over "
            f"{w.backend} (nccl where each rank has a card of its own, "
            f"gloo where ranks share one or run on the CPU); rank "
            f"{w.rank} on {device}, global batch "
            f"{args.batch_size * w.world}")
        return run(args)
    finally:
        shutdown()
        make_world(torch.device("cpu"))


def _spawned_rank(rank: int, world: int, address: str, argv) -> int:
    """A rank that ``--num_gpu`` spawned (``parallel.launch``)."""
    return run_rank(rank, world, address, parse_args(argv)[0])


def main(argv=None) -> int:
    args, unparsed = parse_args(argv)
    set_precision()
    log("*** Parsed arguments ***")
    log(json.dumps(vars(args), indent=1, default=str))
    if unparsed:
        log(f"WARNING: ignoring unknown flags {unparsed}")
    if args.coordinator_address:
        if args.num_gpu > 1:
            log(f"NOTE: --num_gpu={args.num_gpu} ignored in multi-process "
                f"mode; one rank a process, {args.num_processes} ranks")
        return run_rank(args.process_id, args.num_processes,
                        args.coordinator_address, args)
    ranks = spawned_ranks(args)
    if ranks > 1:
        return launch(_spawned_rank, ranks,
                      args=(sys.argv[1:] if argv is None else list(argv),))
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
