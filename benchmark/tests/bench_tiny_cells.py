"""The cells this file's tests add to ``bench_tiny``'s, cut to run in
seconds on the CPU: SEGAN (9-wide frames spliced +-3, 63 a row, 4
targets, encoder and D depths 4, 8, 8, 16 at the configuration's widths
20 and 31, 48 utterances of 20-40 frames in batches of 8) and the
four-rank flagship (``bench_tiny``'s cut, 2 rows a rank, on 200
utterances so that a window does not run out of plans)."""

import copy

from bench_tiny import tiny_cell

from benchmark import harness

DEPTHS = [4, 8, 8, 16]
IN, OUT, CONTEXT = 9, 4, 3


def tiny_segan_cell(name: str = "segan_b256", **limits) -> harness.Cell:
    c = harness.cell(name)
    cfg = copy.deepcopy(c.config)
    cfg["generator"].update(input_dim=IN, output_dim=OUT,
                            enc_depths=DEPTHS)
    cfg["discriminator"].update(num_fmaps=DEPTHS,
                                input_width=IN * (2 * CONTEXT + 1) + OUT)
    cfg["cli"] = [f for f in cfg["cli"] if not f.startswith(
        ("--input_dim", "--output_dim", "--g_enc_depths"))]
    cfg["cli"] += [f"--input_dim={IN}", f"--output_dim={OUT}",
                   "--g_enc_depths=" + ",".join(map(str, DEPTHS))]
    mix = dict(c.mix, utterances=48, min_frames=20, max_frames=40,
               batch_size=8)
    workload = dict(c.workload, limits={**c.workload["limits"], **limits})
    return harness.Cell(name, c.entry, workload, cfg, mix)


def tiny_dp_cell(name: str = "gan_b8x4", **limits) -> harness.Cell:
    c = tiny_cell(name, f32=True, **limits)
    c.mix["utterances"] = 200
    return c
