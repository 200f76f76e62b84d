#!/usr/bin/env python3
"""Time the port's K1 (emission) and K2 (segment) CUDA kernels of this tree
against those of another checkout of the repository, on one card.

    mkdir -p build/ab_parent
    git archive <commit> | tar -x -C build/ab_parent
    python3 kernel_ab.py build/ab_parent

Each side runs in a fresh process from its own root, in the order other,
this, this, other, so a drift of the card's clocks shows as a difference
between the two runs of one side.  A side builds its own kernels, runs its
own `chip_smoke.phase_kernels` (every kernel against its plain version at
the synthetic main and deep shapes, with times), and then times its K1 and
K2 wrappers on the arguments that this tree's batched run (the slice of
chip_smoke phase 4) passed at each kernel's two most frequent launch
shapes, captured once by this tree, in float32 and float64: checked
against the side's plain version, then timed by this tree's
`chip_smoke.event_ms` (CUDA events over 20 launches after a warm-up, L2
warm and L2 flushed).  The wrappers' signatures are the same on both
sides.  Prints the card's name and power limit, then one line `AB {json}`
per side run.  Needs one CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
TOP_SHAPES = 2


def this_smoke():
    """This tree's chip_smoke.py, loaded by path: a side run imports its
    own `chip_smoke`, but times with this one's `event_ms`."""
    spec = importlib.util.spec_from_file_location(
        "kernel_ab_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def capture(data: str, saved: str) -> None:
    """Run this tree's batched slice on `data` once and save, for K1 and
    K2, the arguments of the first launch at each of the two most frequent
    shapes (CPU copies), with the shape and its launch count."""
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as c
    from hipstr_tpu_torch import cli, kernels
    from hipstr_tpu_torch.ops import hmm2
    args = ["--bams", f"{data}/sim.bam", "--fasta", f"{data}/sim.fa",
            "--regions", f"{data}/regions.bed", "--min-reads", "15",
            "--use-unpaired", "--def-stutter-model", "--batch-loci", "32",
            "--dtype", "float32", "--device", "cuda", "--silent",
            "--str-vcf", f"{data}/ab.vcf"]
    kernels.reset_launches()
    k1 = c.Capture(hmm2, "stutter_emissions", c.shape_emission)
    k2 = c.Capture(hmm2, "segment_kernel", c.shape_segment)
    with k1, k2:
        cli.run(args)
    out = {}
    for name, cap in (("emission", k1), ("segment", k2)):
        hist = kernels.SHAPES[name]
        out[name] = []
        for shape, count in hist.most_common(TOP_SHAPES):
            a, kw = cap.args[shape]
            out[name].append((shape, count, [x.cpu() for x in a], kw))
    torch.save(out, saved)


def side(root: str, data: str, saved: str) -> dict:
    """One side's run, in this process (started from `root`)."""
    timing = this_smoke()
    sys.path[:] = [root] + [p for p in sys.path
                            if os.path.abspath(p or ".") != HERE]
    os.chdir(root)
    import torch
    import chip_smoke as c
    from hipstr_tpu_torch.ops import hmm2
    from hipstr_tpu_torch.ops.emission import stutter_emissions
    from hipstr_tpu_torch.ops.stutter_emission import stutter_emissions_plain
    c.phase_build()
    device = torch.device("cuda")
    kres = c.phase_kernels(device, data)
    synthetic = {f"{label} {dt}": {k: list(v) for k, v in r.items()}
                 for (label, dt), r in kres.items()}
    fns = {"emission": (stutter_emissions, stutter_emissions_plain),
           "segment": (hmm2.segment_kernel, hmm2.segment_forward_plain)}
    flush = torch.empty(timing.FLUSH_BYTES, dtype=torch.uint8, device=device)
    real = []
    for name, rows in torch.load(saved).items():
        kernel, plain = fns[name]
        for shape, count, args, kw in rows:
            for dt in (torch.float32, torch.float64):
                dname = str(dt).split(".")[-1]
                a = [x.to(device).to(dt) if x.is_floating_point()
                     else x.to(device) for x in args]
                err = c.compare(name, kernel(*a, **kw), plain(*a, **kw),
                                dname)
                real.append(dict(
                    kernel=name, shape=list(shape), launches=count,
                    dtype=dname, max_abs_err=err,
                    ms_warm=timing.event_ms(lambda: kernel(*a, **kw),
                                            timing.REAL_REPS),
                    ms=timing.event_ms(lambda: kernel(*a, **kw),
                                       timing.REAL_REPS, flush)))
    return dict(root=root, synthetic=synthetic, real=real)


def main(argv) -> int:
    import torch
    if len(argv) >= 2 and argv[0] == "--side":
        root, data, saved = argv[1:4]
        print("AB " + json.dumps(side(root, data, saved)), flush=True)
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: needs one CUDA card", file=sys.stderr)
        return 1
    other = os.path.abspath(argv[0])
    if not os.path.isfile(os.path.join(other, "chip_smoke.py")):
        print(f"kernel_ab: {other} holds no chip_smoke.py", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from hipstr_tpu_torch.utils.simdata import trio_loci, write_sim
    import chip_smoke as c
    print(c.nvidia_smi_line(), flush=True)
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        write_sim(tmp, trio_loci(c.SLICE_LOCI, c.SLICE_READS))
        saved = os.path.join(tmp, "real_args.pt")
        capture(tmp, saved)
        for root in (other, HERE, HERE, other):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--side", root,
                 tmp, saved], cwd=root, capture_output=True, text=True)
            lines = proc.stdout.splitlines()
            print("\n".join(l for l in lines if not l.startswith("  ptxas")),
                  flush=True)
            if proc.returncode:
                print(proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
