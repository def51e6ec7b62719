"""Train/decode entry point of the port (``rsrgan_tpu/cli/train.py``).

The flags are the JAX CLI's, plus ``--device``. This port runs, on
``--device`` (default ``cuda``; it raises when there is no card unless
``--device=cpu`` is given):

* training for ``--trainer gan_rnn`` (the flagship LSGAN): 1 D + 2 G
  steps per batch on the same batch, or with ``--same_batch=false`` D and
  G steps on successive batches (the graph-fed loop); ``--d_conditioned``;
  ``--g_type lstm|res_lstm_*``; ``--keep_prob`` (dropout between the
  LSTM layers of G and of D; G then runs per layer, K1 forward, as in
  JAX); CV eval, the completed-epoch schedules, accept/reject,
  checkpoints and the ``.meta.json`` sidecar in the JAX format, so either
  package resumes or decodes the other's checkpoints; periodic snapshots
  (``--checkpoint_every_secs``, a newer one wins on resume); JSONL metrics
  and, with ``--tensorboard`` (the default), event files under
  ``save_dir/train`` and ``save_dir/eval``. Batches run in the JAX CLI's update
  order (``dispatch_order``: same-shape groups of ``--steps_per_call``).
  Their feed: ``--device_feed`` (auto: on where ``--device`` is a card)
  keeps the corpus resident on the device and gathers each batch there
  from a ``[B]`` plan, rotating resident shards (``--feed_rotation_block``,
  ``--feed_prefetch``) when the tables exceed ``RSRGAN_FEED_HBM_BUDGET``;
  otherwise, and for the graph-fed loop, a prefetch thread builds host
  batches;
* ``--decode`` for the sequence trainers (``--trainer gan_rnn|rnn``): G
  forward, CMVN denormalisation, Kaldi feats.ark/feats.scp (``--compress``:
  compressed matrices, ``--text``: a text archive).

``--lstm_impl auto|wavefront`` runs the hand-written kernels (the
wavefront stack for G, the single-layer kernels for D below 64 rows),
``pallas`` the single-layer kernels for every layer, ``scan`` the eager
cell under autograd (the f32 oracle). Everything else raises
``NotImplementedError`` naming its ROADMAP.md item.

    python -m rsrgan_tpu_torch.cli.train --trainer=gan_rnn \\
        --g_type=res_lstm_l --tr_list_file=tr.list --cv_list_file=cv.list \\
        --batch_size=16 --save_dir=exp/gan_rnn
    python -m rsrgan_tpu_torch.cli.train --decode --trainer=gan_rnn \\
        --g_type=res_lstm_l --data_dir=DATA --test_list_file=test.list \\
        --save_dir=exp/gan_rnn --decode_batch_size=16
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

from rsrgan_tpu_torch.cli import str2bool
from rsrgan_tpu_torch.data import (ArkWriter, SequenceBatcher, StoreView,
                                   ThreadedPrefetcher, UtteranceStore,
                                   bucket_id, infer_batches, load_cmvn_npz,
                                   padded_length, read_list_file,
                                   splice_frames_np)
from rsrgan_tpu_torch.data.device_feed import (DeviceFeed,
                                               RotatingDeviceFeed,
                                               table_bytes)
from rsrgan_tpu_torch.models import (get_discriminator, get_generator,
                                     load_flax_params)
from rsrgan_tpu_torch.training import (GanTrainer, ImprovementTracker,
                                       exponential_decay, load_checkpoint,
                                       load_generator_params,
                                       load_newest_state,
                                       read_checkpoint_meta, save_checkpoint,
                                       save_periodic_snapshot, state_tree)
from rsrgan_tpu_torch.training.tensorboard import EventFileWriter

GAN_METRICS = ("d_rl_loss", "d_fk_loss", "d_loss", "g_adv_loss",
               "g_mse_loss", "g_l2_loss", "g_loss")

_ROADMAP = "see ROADMAP.md, Queue 1"


def log(msg: str) -> None:
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


def resolve_device(name: str) -> torch.device:
    """The run's device. A CUDA device that is not there is an error: the
    CLI never carries on on the CPU unless asked to."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device={name} but no CUDA device is available (pass "
            "--device=cpu to run the plain PyTorch path on the CPU)")
    return device


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


def run_decode(args) -> int:
    if args.trainer not in ("gan_rnn", "rnn"):
        raise NotImplementedError(
            f"--decode --trainer={args.trainer} is not ported yet; "
            f"{_ROADMAP}, 'MSE and frame trainers'")
    if args.num_gpu > 1:
        raise NotImplementedError(
            f"--num_gpu={args.num_gpu} (data-parallel decode) is not ported "
            f"yet; {_ROADMAP}, 'Parallel'")
    device = resolve_device(args.device)
    compute_dtype = torch.bfloat16 if args.bf16 else torch.float32
    name = model_name(args)
    validate_checkpoint_compat(args, name)
    splice = args.left_context + 1 + args.right_context
    gen = get_generator(args.g_type, input_dim=args.input_dim * splice,
                        output_dim=args.output_dim,
                        compute_dtype=compute_dtype,
                        lstm_impl=resolve_lstm_impl(args))
    params = load_generator_params(args.save_dir, name, args.moving_average)
    if params is None:
        log("[!] Load failed. Checkpoint not found. Exit now.")
        return 1
    load_flax_params(gen, params)
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

    def infer(inputs: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        out = gen(torch.from_numpy(inputs).to(device),
                  torch.from_numpy(lengths).to(device))
        return out.float().cpu().numpy()

    start = datetime.datetime.now()
    with ArkWriter(os.path.join(out_dir, "feats.scp"),
                   compress=args.compress, text=args.text) as writer:
        if args.decode_batch_size > 1:
            _decode_batched(args, test_store, infer, labels_cmvn, writer,
                            ark_path)
        else:
            num_batch = len(test_store)
            for i, batch in enumerate(infer_batches(test_store,
                                                    args.left_context,
                                                    args.right_context)):
                act = infer(batch.inputs, batch.lengths)
                act = act[0, :int(batch.lengths[0])]
                writer.write_next_utt(ark_path, batch.utt_ids[0],
                                      labels_cmvn.denormalize(act))
                log(f"[{i + 1}/{num_batch}] Write inferred "
                    f"{batch.utt_ids[0]} to {ark_path}")
    took = (datetime.datetime.now() - start).total_seconds()
    frames = int(test_store.lengths.sum())
    log(f"Decoding time is {took}s ({frames} frames, "
        f"{frames / max(took, 1e-9):.0f} frames/s on {device})")
    return 0


def _decode_batched(args, test_store, infer, labels_cmvn, writer,
                    ark_path) -> None:
    """Batched enhancement: group utterances by padded length (128-frame
    quantization), run B at a time, write results back in scp order."""
    B = args.decode_batch_size
    lengths = test_store.lengths
    pad = [int(-(-l // 128) * 128) for l in lengths]
    order = sorted(range(len(test_store)), key=lambda i: (pad[i], i))
    splice = args.left_context + 1 + args.right_context
    results = {}
    idx = 0
    while idx < len(order):
        t_pad = pad[order[idx]]
        group = []
        while (idx < len(order) and len(group) < B
               and pad[order[idx]] == t_pad):
            group.append(order[idx])
            idx += 1
        x = np.zeros((len(group), t_pad, test_store.input_dim * splice),
                     np.float32)
        lens = np.full((len(group),), t_pad, np.int32)
        for row, i in enumerate(group):
            feats = splice_frames_np(np.asarray(test_store.inputs(i)),
                                     args.left_context, args.right_context)
            x[row, :feats.shape[0]] = feats
            lens[row] = feats.shape[0]
        act = infer(x, lens)
        for row, i in enumerate(group):
            results[i] = labels_cmvn.denormalize(act[row, :lens[row]])
    for i in range(len(test_store)):
        writer.write_next_utt(ark_path, test_store.utt_ids[i], results[i])
    log(f"Wrote {len(results)} utterances (batched decode, B={B})")


def ckpt_meta(args) -> dict:
    """The model-config sidecar saved next to checkpoints (as the JAX
    CLI writes it)."""
    return {"trainer": args.trainer, "g_type": args.g_type,
            "input_dim": args.input_dim, "output_dim": args.output_dim,
            "left_context": args.left_context,
            "right_context": args.right_context,
            "d_conditioned": bool(args.d_conditioned)}


def _fmt(metrics: dict, keys) -> str:
    return ", ".join(f"{k} = {float(metrics[k]):.5f}" for k in keys)


def _avg(accum: list) -> dict:
    """Per-step mean of the metrics, read back from the device in one
    copy."""
    keys = list(accum[0])
    vals = torch.stack([torch.stack([torch.as_tensor(m[k]).float()
                                     for k in keys]) for m in accum]).cpu()
    return {k: float(v) for k, v in zip(keys, vals.mean(0).tolist())}


class MetricsWriter:
    """The JAX CLI's metrics sink: ``metrics_{split}.jsonl``, one line per
    iteration, and with ``tensorboard`` the same scalars as TensorBoard
    event files under ``save_dir/{split}``."""

    def __init__(self, save_dir: str, split: str, tensorboard: bool):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, f"metrics_{split}.jsonl")
        self._tb = (EventFileWriter(os.path.join(save_dir, split))
                    if tensorboard else None)

    def write(self, iteration: int, metrics: dict) -> None:
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
    (checked after each update); off at 0."""

    def __init__(self, save_dir: str, name: str, every_secs: float):
        self.save_dir, self.name, self.every = save_dir, name, every_secs
        self._last = time.monotonic()

    def maybe(self, state) -> None:
        if self.every <= 0 or time.monotonic() - self._last < self.every:
            return
        save_periodic_snapshot(self.save_dir, self.name, state_tree(state))
        self._last = time.monotonic()
        log(f"Periodic snapshot saved ({self.name}.periodic.ckpt)")


def restore_state(args, name: str, state) -> Tuple[Optional[str], str]:
    """Restore the latest accepted checkpoint into ``state``; with
    periodic snapshots on, a newer snapshot wins (crash recovery).
    Returns (the file restored or None, its kind)."""
    if args.checkpoint_every_secs > 0:
        return load_newest_state(args.save_dir, name, state)
    return load_checkpoint(args.save_dir, name, state), "checkpoint"


def build_trainer(args, device, compute_dtype) -> GanTrainer:
    gen = torch.Generator().manual_seed(args.seed)
    splice = args.left_context + 1 + args.right_context
    impl = resolve_lstm_impl(args)
    # --keep_prob drops out between the LSTM layers of G and of D, as the
    # JAX CLI passes it to both
    g = get_generator(args.g_type, input_dim=args.input_dim * splice,
                      output_dim=args.output_dim, keep_prob=args.keep_prob,
                      compute_dtype=compute_dtype, lstm_impl=impl,
                      generator=gen)
    # a conditioned D sees the center input frame beside its target
    d_in = args.output_dim + (args.input_dim if args.d_conditioned else 0)
    d = get_discriminator("lstm", input_dim=d_in,
                          keep_prob=args.keep_prob,
                          compute_dtype=compute_dtype, lstm_impl=impl,
                          generator=gen)
    trainer = GanTrainer(g.to(device), d.to(device),
                         output_dim=args.output_dim, input_dim=args.input_dim,
                         left_context=args.left_context,
                         disc_updates=args.disc_updates,
                         gen_updates=args.gen_updates,
                         l2_scale=args.l2_scale, max_grad_norm=15.0,
                         g_optimizer="adam", d_optimizer="sgd",
                         d_conditioned=args.d_conditioned)
    # the dropout masks' streams, apart from D's input noise (seed + 1)
    trainer.seed_dropout(args.seed + 2, device)
    return trainer


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

    The gathered path covers the sequence trainers in a single process,
    except the graph-fed GAN (--same_batch=false), which keeps the host
    feed. ``auto`` turns it on where the run's device is a card, ``on``
    on any device. Tables over the budget (RSRGAN_FEED_HBM_BUDGET, bytes;
    default ``default_feed_budget``) drop to bfloat16, and bfloat16 tables
    over it rotate resident shards (RotatingDeviceFeed).
    """
    if args.device_feed == "off":
        return None
    eligible = (args.trainer in ("gan_rnn", "rnn")
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


def dispatch_plans(batchers, steps_per_call: int
                   ) -> List[Tuple[List[int], int]]:
    """(indices, t_pad) of every batch plan of ``batchers`` (one pass each,
    in turn) in dispatch order."""
    plans = [(b, ix) for b in batchers for ix in b.iter_index_batches()]
    keys = [plan_key(b.lengths[ix], b.num_buckets) for b, ix in plans]
    return [(plans[i][1], keys[i][0])
            for i in dispatch_order(keys, steps_per_call)]


def plan_to_device(starts: np.ndarray, lengths: np.ndarray,
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One [B] plan to the device through a small pinned buffer, without
    waiting for the copy (the caching host allocator keeps the buffer
    until the copy has read it)."""
    host = torch.from_numpy(np.stack([starts, lengths]).astype(np.int32))
    if device.type == "cuda":
        host = host.pin_memory()
    dev = host.to(device, non_blocking=True)
    return dev[0], dev[1]


def run_sequence_training(args) -> int:
    """The sequence GAN loop of the JAX CLI (``run_sequence_training``)
    for --trainer=gan_rnn: the device feed (resident or rotating tables),
    the graph-fed loop (--same_batch=false) or the host feed."""
    if args.trainer != "gan_rnn":
        raise NotImplementedError(
            f"training (--trainer={args.trainer}) is not ported yet; "
            f"{_ROADMAP}, 'MSE and frame trainers'")
    if args.num_gpu > 1:
        raise NotImplementedError(
            f"--num_gpu={args.num_gpu} (data-parallel training) is not "
            f"ported yet; {_ROADMAP}, 'Parallel'")
    device = resolve_device(args.device)
    compute_dtype = torch.bfloat16 if args.bf16 else torch.float32
    trainer = build_trainer(args, device, compute_dtype)
    name = model_name(args)

    tr_store = UtteranceStore(read_list_file(args.tr_list_file))
    cv_store = UtteranceStore(read_list_file(args.cv_list_file))

    def make_batcher(store, shuffle):
        b = SequenceBatcher(store, args.batch_size, args.left_context,
                            args.right_context, shuffle=shuffle,
                            seed=args.seed)
        if b.num_batches() == 0:
            # small sets: keep the ragged batches of partial buckets
            b = SequenceBatcher(store, args.batch_size, args.left_context,
                                args.right_context, shuffle=shuffle,
                                drop_remainder=False, seed=args.seed)
        return b

    tr_batches = make_batcher(tr_store, True)
    cv_batches = make_batcher(cv_store, False)
    min_iters, max_iters = args.min_epoches, args.max_epoches
    log(f"LOG: #train_batch = {tr_batches.num_batches()}, #valid_batch = "
        f"{cv_batches.num_batches()}\n"
        f"LOG: #min_iters = {min_iters}, #max_iters = {max_iters}")

    state = trainer.init_state()
    restored, restore_src = restore_state(args, name, state)
    log(f"[*] Load SUCCESS ({restore_src})" if restored
        else "[!] Begin a new model.")
    snapper = PeriodicSnapshotter(args.save_dir, name,
                                  args.checkpoint_every_secs)
    g_count = sum(p.numel() for p in state.g.params().values())
    d_count = sum(p.numel() for p in state.d.params().values())
    log(f"G variables: {g_count / 1e6:.2f}M params; "
        f"D variables: {d_count / 1e6:.2f}M params")
    hp = {"g_lr": args.g_learning_rate, "d_lr": args.d_learning_rate,
          "mse_lambda": args.init_mse_weight,
          "disc_noise_std": args.init_disc_noise_std,
          "d_real": 1.0, "d_fake": 0.0}
    tracker = ImprovementTracker(args.end_improve)
    noise = torch.Generator(device=device).manual_seed(args.seed + 1)
    tr_writer = MetricsWriter(args.save_dir, "train", args.tensorboard)
    cv_writer = MetricsWriter(args.save_dir, "eval", args.tensorboard)
    steps_per_call = max(1, args.steps_per_call)
    left, right = args.left_context, args.right_context

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
            for indices, t_pad in dispatch_plans(batchers, steps_per_call):
                st, le = feed_tr.plan(indices)
                true_frames += int(le.sum())
                tr_accum.append(trainer.train_step_gathered(
                    state, feed_tr.inputs_tbl, feed_tr.labels_tbl,
                    *plan_to_device(st, le, device), hp, noise, t_pad,
                    left, right))
                snapper.maybe(state)
            tr_m = _avg(tr_accum) if tr_accum else None
        elif not args.same_batch:
            # graph-fed: D and G steps on successive minibatches of the
            # stream, until it runs out (wherever that falls)
            d_accum, g_accum = [], []
            stream = iter(ThreadedPrefetcher(iter(tr_batches), 32))
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
            plans = dispatch_plans([tr_batches], steps_per_call)
            for batch in ThreadedPrefetcher(
                    (tr_batches._make_batch(ix) for ix, _ in plans), 32):
                true_frames += int(batch.lengths.sum())
                tr_accum.append(trainer.train_step(
                    state, *on_device(batch), hp, noise))
                snapper.maybe(state)
            tr_m = _avg(tr_accum) if tr_accum else None
        if tr_m is None:
            log("ERROR: empty train batch stream")
            return 1
        sync()   # _avg read the metrics back; the train section is done
        train_secs = (datetime.datetime.now() - start).total_seconds()
        if feed_cv is not None:
            for indices, t_pad in dispatch_plans([cv_batches],
                                                 steps_per_call):
                st, le = feed_cv.plan(indices)
                cv_accum.append(trainer.eval_step_gathered(
                    state, feed_cv.inputs_tbl, feed_cv.labels_tbl,
                    *plan_to_device(st, le, device), hp, noise, t_pad,
                    left, right))
        else:
            plans = dispatch_plans([cv_batches], steps_per_call)
            for batch in ThreadedPrefetcher(
                    (cv_batches._make_batch(ix) for ix, _ in plans), 32):
                cv_accum.append(trainer.eval_step(
                    state, *on_device(batch), hp, noise))
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
            f"{_fmt(tr_m, GAN_METRICS)}\n"
            f"{iteration + 1}/{n_iterations} (CROSS AVG.LOSS): "
            f"{_fmt(cv_m, GAN_METRICS)}")
        tr_row = {**tr_m, "train_frames_per_sec": fps,
                  "train_secs": train_secs, "train_steps": len(tr_accum),
                  "g_lr": hp["g_lr"], "d_lr": hp["d_lr"]}
        if rotating:
            tr_row["eff_epoch"] = eff_epoch
        tr_writer.write(iteration + 1, tr_row)
        cv_writer.write(iteration + 1, cv_m)

        # the reference's staircase: epoch 1 at the initial values, epoch
        # k >= 2 at decay(k - 1) on completed epochs. Under rotation a
        # residency can end mid-epoch, so the count is of whole effective
        # epochs, and the initial values hold until the first completes.
        sched_t = int(eff_epoch) if rotating else iteration + 1
        if sched_t >= 1:
            hp["g_lr"] = exponential_decay(sched_t, 1, min_iters,
                                           args.g_learning_rate)
            hp["d_lr"] = exponential_decay(sched_t, 1, min_iters,
                                           args.d_learning_rate)
            hp["disc_noise_std"] = exponential_decay(
                sched_t, 1, min_iters, args.init_disc_noise_std,
                multiply_jobs=False)

        tracker.add(cv_m["g_loss"])
        if tracker.check(iteration):
            save_checkpoint(args.save_dir, name, state_tree(state),
                            iteration + 1, meta=ckpt_meta(args))
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
    p.add_argument("--profile_dir", type=str, default=None)
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


def main(argv=None) -> int:
    args, unparsed = build_parser().parse_known_args(argv)
    apply_flag_aliases(args)
    log("*** Parsed arguments ***")
    log(json.dumps(vars(args), indent=1, default=str))
    if unparsed:
        log(f"WARNING: ignoring unknown flags {unparsed}")
    if args.coordinator_address:
        raise NotImplementedError(
            f"multi-process runs are not ported yet; {_ROADMAP}, 'Parallel'")
    if args.decode:
        return run_decode(args)
    return run_sequence_training(args)


if __name__ == "__main__":
    sys.exit(main())
