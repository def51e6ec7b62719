"""Streaming enhancement CLI: bounded-latency serving over Kaldi I/O
(counterpart of ``rsrgan_tpu/cli/serve.py``).

Runs a trained generator through ``serving.StreamingEnhancer``,
processing each utterance in fixed-size chunks with carried recurrent
state — the processing mode an online dereverberation front-end needs.
The chunked forward is exact (the generators are causal), so the emitted
feats.ark/feats.scp match an offline ``cli.train --decode`` up to the
products' summation order.

The flags are the JAX CLI's, plus ``--device`` (default ``cuda``; it
raises when there is no card unless ``--device=cpu`` is given). G's
parameters are read as ``cli.train --decode`` reads them (a whole train
state or G's tree alone) and loaded into the generator these flags
describe, so a checkpoint of another model fails to load; ``--g_type``
is checked against the checkpoint's ``.meta.json`` sidecar, the only
guard between the shape-identical res_lstm_l and res_lstm_base trees.
f32 is f32 on the card (no TF32, ``device.set_precision``).

Usage::

    python -m rsrgan_tpu_torch.cli.serve \\
        --save_dir exp/gan_res_lstm_l --data_dir data/train/train_100h \\
        --test_list_file data/test/test001/test.list --chunk_frames 50

    # wav -> wav streaming (LPS->LPS checkpoints, --output_dim 257):
    python -m rsrgan_tpu_torch.cli.serve \\
        --save_dir exp/gan_lps2lps --data_dir data/train \\
        --wav_scp noisy_wav.scp --output_dim 257 --chunk_frames 50 \\
        --num_streams 8

The wav mode runs the whole pipeline online — streaming LPS analysis,
carried-state generator forward, WOLA resynthesis with the current
chunk's noisy phase (``serving/wav_stream.py``) — and writes enhanced
wavs plus a wav.scp; ``--num_streams > 1`` interleaves the wavs through
one batched ``StreamPool``.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys

import numpy as np
import torch

from rsrgan_tpu_torch.cli import resolve_device, set_precision, str2bool
from rsrgan_tpu_torch.data import (ArkWriter, UtteranceStore, infer_batches,
                                   load_cmvn_npz, read_list_file)
from rsrgan_tpu_torch.serving import StreamingEnhancer

def log(msg: str) -> None:
    print(msg)
    sys.stdout.flush()


def load_generator_params(args):
    """The generator's parameter tree (nested dicts of numpy arrays, flax
    names) from a training checkpoint, or None when there is none. The
    tree must be the parameters of the generator the flags describe, so
    a checkpoint of another model or width raises here."""
    from rsrgan_tpu_torch.cli.train import model_name
    from rsrgan_tpu_torch.models import get_generator, load_flax_params
    from rsrgan_tpu_torch.serving.streaming import SUPPORTED_VARIANTS
    from rsrgan_tpu_torch.training import (load_generator_params as load_g,
                                           read_checkpoint_meta)

    if args.g_type not in SUPPORTED_VARIANTS:
        raise SystemExit(f"serve supports --g_type in {SUPPORTED_VARIANTS} "
                         f"(got {args.g_type})")
    name = model_name(args)
    meta = read_checkpoint_meta(args.save_dir, name)
    if meta is not None and meta.get("g_type") not in (None, args.g_type):
        # the param trees of res_lstm_l / res_lstm_base are shape-identical,
        # so only this sidecar can catch serving with the wrong wiring
        raise SystemExit(
            f"checkpoint in {args.save_dir} was trained with "
            f"--g_type={meta['g_type']} but serve got "
            f"--g_type={args.g_type}; serving with the wrong wiring would "
            "silently produce garbage")
    params = load_g(args.save_dir, name, args.moving_average)
    if params is not None:
        load_flax_params(get_generator(
            args.g_type, input_dim=args.input_dim,
            output_dim=args.output_dim, left_context=args.left_context,
            right_context=args.right_context, lstm_impl="scan"), params)
    return params


def _stream_single(args, params, inputs_cmvn, labels_cmvn, opts, entries,
                   out_dir, scp, device):
    """One stream at a time through StreamingWavEnhancer."""
    from rsrgan_tpu_torch.serving.wav_stream import StreamingWavEnhancer
    from rsrgan_tpu_torch.sim.wavio import read_wav, write_wav

    enhancer = StreamingWavEnhancer(
        params, inputs_cmvn, labels_cmvn, variant=args.g_type,
        frame_opts=opts, chunk_frames=args.chunk_frames, device=device)
    # feed in chunk-sized sample blocks (frames * shift per step)
    block = args.chunk_frames * opts.window_shift
    total = 0
    for i, (utt_id, wav_path) in enumerate(entries):
        wave, rate = read_wav(wav_path)
        if rate != opts.samp_freq:
            log(f"WARNING: {utt_id} rate {rate} != {opts.samp_freq:g}")
        enhancer.reset()
        outs = [enhancer.process(wave[lo:lo + block])
                for lo in range(0, len(wave), block)]
        outs.append(enhancer.flush())
        y = np.concatenate(outs)
        out_path = os.path.join(out_dir, f"{utt_id}.wav")
        write_wav(out_path, y, rate=int(rate))
        scp.write(f"{utt_id} {out_path}\n")
        total += len(wave)
        log(f"[{i + 1}/{len(entries)}] Streamed {utt_id} "
            f"({len(wave)} samples, blocks of {block})")
    return total


def _stream_pooled(args, params, inputs_cmvn, labels_cmvn, opts, entries,
                   out_dir, scp, device):
    """All wavs interleaved through one batched StreamPool: every device
    step carries up to --num_streams lanes, so throughput scales with
    concurrency instead of paying batch-1 latency per chunk."""
    from rsrgan_tpu_torch.serving.pool import StreamPool
    from rsrgan_tpu_torch.sim.wavio import read_wav, write_wav

    pool = StreamPool(params, inputs_cmvn, labels_cmvn,
                      variant=args.g_type, frame_opts=opts,
                      chunk_frames=args.chunk_frames,
                      capacity=args.num_streams, device=device)
    block = args.chunk_frames * opts.window_shift
    todo = list(entries)
    active = {}  # sid -> [utt_id, wave, pos, outs, rate]
    done = total = 0
    while todo or active:
        while todo and pool.active < pool.capacity:
            utt_id, wav_path = todo.pop(0)
            wave, rate = read_wav(wav_path)
            if rate != opts.samp_freq:
                log(f"WARNING: {utt_id} rate {rate} != {opts.samp_freq:g}")
            active[pool.open()] = [utt_id, wave, 0, [], int(rate)]
        for sid in list(active):
            utt_id, wave, pos, outs, rate = active[sid]
            if pos < len(wave):
                outs.append(pool.feed(sid, wave[pos:pos + block]))
                active[sid][2] = pos + block
            else:
                outs.append(pool.close(sid))
                y = np.concatenate(outs)
                out_path = os.path.join(out_dir, f"{utt_id}.wav")
                write_wav(out_path, y, rate=rate)
                scp.write(f"{utt_id} {out_path}\n")
                total += len(wave)
                done += 1
                log(f"[{done}/{len(entries)}] Streamed {utt_id} "
                    f"({len(wave)} samples, {pool.active} peers)")
                del active[sid]
    log(f"Pool: {pool.steps_run} batched dispatches, "
        f"{pool.frames_run} frames "
        f"({pool.frames_run / max(pool.steps_run, 1):.1f} per dispatch, "
        f"capacity {pool.capacity * args.chunk_frames})")
    return total


def serve_wavs(args, params, inputs_cmvn, labels_cmvn, device) -> int:
    """wav->wav streaming over an scp of noisy wavs."""
    from rsrgan_tpu_torch.features.frontend import FrameOptions

    opts = FrameOptions(dither=0.0)
    out_dir = args.output_dir or os.path.join(args.save_dir, "stream_wav")
    os.makedirs(out_dir, exist_ok=True)
    with open(args.wav_scp) as f:
        entries = [line.strip().split(None, 1) for line in f if line.strip()]

    runner = _stream_pooled if args.num_streams > 1 else _stream_single
    start = datetime.datetime.now()
    with open(os.path.join(out_dir, "wav.scp"), "w") as scp:
        total = runner(args, params, inputs_cmvn, labels_cmvn, opts,
                       entries, out_dir, scp, device)
    took = (datetime.datetime.now() - start).total_seconds()
    mode = (f"{args.num_streams} pooled streams"
            if args.num_streams > 1 else "single stream")
    log(f"Streaming done: {total} samples in {took:.2f}s "
        f"({total / max(took, 1e-9) / opts.samp_freq:.2f}x realtime "
        f"host-synced, {mode})")
    return 0


def serve_features(args, enhancer, labels_cmvn) -> int:
    """Each utterance of the test store in zero-padded chunks of
    --chunk_frames; denormalized outputs to a Kaldi ark."""
    store = UtteranceStore(read_list_file(args.test_list_file))
    out_dir = args.output_dir or os.path.join(args.save_dir, "stream")
    os.makedirs(out_dir, exist_ok=True)
    writer = ArkWriter(os.path.join(out_dir, "feats.scp"),
                       compress=args.compress)
    ark_path = os.path.join(out_dir, "feats.ark")

    start = datetime.datetime.now()
    total_frames = 0
    n = len(store)
    C = args.chunk_frames
    for i, batch in enumerate(infer_batches(store, args.left_context,
                                            args.right_context)):
        (utt_id,) = batch.utt_ids
        T = int(batch.lengths[0])
        x = batch.inputs[:1, :T]  # [1, T, D] (unpadded)
        state = enhancer.init_state(batch=1)
        outs = []
        for lo in range(0, T, C):
            take = min(C, T - lo)
            chunk = np.zeros((1, C, x.shape[-1]), np.float32)
            chunk[:, :take] = x[:, lo:lo + take]
            # a fixed [1, C, D] chunk; the final chunk's pad rows pollute
            # only the discarded state
            y, state = enhancer.step(chunk, state)
            outs.append(y[0, :take])
        enhanced = labels_cmvn.denormalize(torch.cat(outs).cpu().numpy())
        writer.write_next_utt(ark_path, utt_id, enhanced.astype(np.float32))
        total_frames += T
        log(f"[{i + 1}/{n}] Streamed {utt_id} "
            f"({T} frames, chunks of {C})")
    writer.close()
    took = (datetime.datetime.now() - start).total_seconds()
    log(f"Streaming done: {total_frames} frames in {took:.2f}s "
        f"({total_frames / max(took, 1e-9):,.0f} frames/s host-synced)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags (same names and defaults) plus --device."""
    p = argparse.ArgumentParser(prog="rsrgan_tpu_torch.cli.serve",
                                description=__doc__.splitlines()[0])
    p.add_argument("--save_dir", required=True)
    p.add_argument("--data_dir", required=True,
                   help="directory holding train_cmvn.npz")
    p.add_argument("--test_list_file", default=None,
                   help="feature-store mode input (required unless "
                        "--wav_scp is given)")
    p.add_argument("--wav_scp", default=None,
                   help="wav->wav streaming mode: scp of noisy wavs "
                        "(needs an LPS->LPS checkpoint, --output_dim 257)")
    p.add_argument("--output_dir", default=None,
                   help="default: <save_dir>/stream (wav mode: "
                        "<save_dir>/stream_wav)")
    p.add_argument("--num_streams", type=int, default=1,
                   help="wav mode: >1 batches this many concurrent "
                        "streams into one step (StreamPool)")
    p.add_argument("--chunk_frames", type=int, default=50,
                   help="frames per streamed chunk (latency bound)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to stream on; 'cuda' fails when no "
                        "GPU is present (it never falls back to the CPU)")
    p.add_argument("--g_type", default="res_lstm_l")
    p.add_argument("--trainer", default="gan_rnn")
    p.add_argument("--input_dim", type=int, default=257)
    p.add_argument("--output_dim", type=int, default=40)
    p.add_argument("--left_context", type=int, default=0)
    p.add_argument("--right_context", type=int, default=0)
    p.add_argument("--keep_prob", type=float, default=1.0)
    p.add_argument("--batch_norm", type=str2bool, nargs="?", const=True,
                   default=False)
    p.add_argument("--l2_scale", type=float, default=0.0)
    p.add_argument("--disc_updates", type=int, default=1)
    p.add_argument("--gen_updates", type=int, default=2)
    p.add_argument("--bf16", type=str2bool, nargs="?", const=True,
                   default=False)
    p.add_argument("--lstm_impl", default="scan",
                   help="accepted for the JAX CLI's flags; streaming "
                        "runs the eager cell")
    p.add_argument("--moving_average", action="store_true")
    p.add_argument("--compress", action="store_true",
                   help="write a Kaldi CompressedMatrix ark")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args, unknown = p.parse_known_args(argv)
    if unknown:
        log(f"WARNING: ignoring unknown flags {unknown}")
    if (args.test_list_file is None) == (args.wav_scp is None):
        p.error("exactly one of --test_list_file / --wav_scp is required")
    set_precision()
    device = resolve_device(args.device)

    params = load_generator_params(args)
    if params is None:
        log("[!] Load failed. Checkpoint not found. Exit now.")
        return 1
    log("[*] Load SUCCESS")

    cmvn_path = os.path.join(args.data_dir, "train_cmvn.npz")
    inputs_cmvn, labels_cmvn = load_cmvn_npz(cmvn_path)

    if args.wav_scp:
        return serve_wavs(args, params, inputs_cmvn, labels_cmvn, device)
    enhancer = StreamingEnhancer(params, variant=args.g_type, device=device)
    return serve_features(args, enhancer, labels_cmvn)


if __name__ == "__main__":
    sys.exit(main())
