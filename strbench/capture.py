"""What the benchmark reads of the program while a run goes on, taken from
outside through its module-level names (the pattern of chip_smoke's
Capture and DispatchLog): the pipeline object, error lines of its log,
each locus's settle time and VCF record as the pool's pipes carry them,
each EM wave's problems and learned models, each dispatch's packed inputs
and device results, the last dispatch of each locus sampled for its
record, and, in a traced run, the arguments that bound each K1 and K2
launch.

Only the hooks add work to the run.  EM waves are sampled from the pool's
start (a cohort's wave can outlast the window); dispatches, launches and
spans while `recording` is on (the measured window).  Samples are drawn
from the seed by reservoir sampling, so they are uniform over the waves
and the window's dispatches; the window's largest dispatch is kept too.
The loci sampled for their records are drawn from the seed before the run
(one in `record_every`): their last dispatch is kept whenever it comes.
"""

from __future__ import annotations

import random
import re
import threading
import time
from typing import Dict, List

import numpy as np

# a locus that failed: the lines run_pooled logs for it
ERROR_LINE = re.compile(r"^(ERROR at|Stutter EM failed for) ")


def plain(x):
    """A packed pytree (NamedTuples of numpy arrays, dicts, tuples) as
    dicts and tuples of numpy arrays: what the reference takes."""
    if hasattr(x, "_fields"):
        return {f: plain(getattr(x, f)) for f in x._fields}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(plain(v) for v in x)
    return np.asarray(x)


class Reservoir:
    """A uniform sample of at most k of the items offered (algorithm R),
    drawn with `rng`."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen = k, rng, 0
        self.items: List = []

    def slot(self):
        """The index the next item goes to, or None to drop it."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = self.rng.randrange(self.seen)
        return j if j < self.k else None


class Spans:
    """Harness spans around calls into the program: (name, start, end) in
    time.perf_counter_ns(), from any thread."""

    def __init__(self):
        self.rows: List[tuple] = []
        self.lock = threading.Lock()
        self.on = False

    def wrap(self, name, fn):
        def inner(*a, **kw):
            if not self.on:
                return fn(*a, **kw)
            t0 = time.perf_counter_ns()
            try:
                return fn(*a, **kw)
            finally:
                with self.lock:
                    self.rows.append((name, t0, time.perf_counter_ns()))
        return inner


class Hooks:
    """Installs the capture on the program's modules; `remove` puts every
    name back."""

    def __init__(self, seed: int, em_sample: int, dispatch_sample: int,
                 loci_per_dispatch: int, launches: bool, loci: int = 0,
                 record_every: int = 0):
        self.rng, self.seed = random.Random(seed), seed
        self.t_open = self.t_close = None     # the window, once it closed
        # loci whose last dispatch is kept, to judge their VCF records
        picks = loci // record_every if record_every else 0
        self.record_pick = set(random.Random(seed + 1).sample(range(loci),
                                                              picks))
        self.last_round: Dict[int, dict] = {}
        self.recording = False
        self.pipeline = None
        self.em = Reservoir(em_sample, self.rng)
        self.em_waves = self.em_problems = 0
        # fused and unfused dispatches are sampled apart, so that a window
        # that holds both kinds compares both
        self.dispatches = {kind: Reservoir(dispatch_sample, self.rng)
                           for kind in (True, False)}
        self.largest = None
        self.loci_per_dispatch = loci_per_dispatch
        self.locus_rounds = 0                # loci dispatched, whole run
        self.want_launches = launches
        self.launches: Dict[str, list] = {"emission": [], "segment": []}
        self.spans = Spans()
        # the pool's pipes: each locus's (settle time, BED index, VCF
        # record or None), in any order, and after `drain` every further
        # locus handed to a worker as a region too long to genotype, which
        # the worker settles at once
        self.settles: List[tuple] = []
        self.error_lines: List[str] = []
        self.drain = False
        self.skipped = set()
        self.chrom_of: Dict[int, str] = {}    # BED index -> contig
        self._undo: List[tuple] = []

    def _set(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def remove(self):
        while self._undo:
            obj, name, value = self._undo.pop()
            setattr(obj, name, value)

    # ------------------------------------------------------------ install
    def install(self):
        from hipstr_tpu_torch import cli
        from hipstr_tpu_torch.ops import hmm2
        from hipstr_tpu_torch.parallel import executor, workers
        hooks = self

        class Pipeline(cli.GenotyperPipeline):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                hooks.pipeline = self

        class Logger(cli.Logger):
            def log(self, *args):
                text = " ".join(str(a) for a in args)
                if ERROR_LINE.match(text):
                    hooks.error_lines.append(text)

        self._set(cli, "GenotyperPipeline", Pipeline)
        self._set(cli, "Logger", Logger)

        self._set(workers, "mp", _Multiprocessing(workers.mp, self))
        solve_em = workers.solve_em

        def recording_solve_em(problems, *a, **kw):
            params, conv = solve_em(problems, *a, **kw)
            # every wave, warm-up included: the cohort's waves are long
            self.em_waves += 1
            self.em_problems += len(problems)
            for i, prob in enumerate(problems):
                j = self.em.slot()
                if j is not None:
                    self.em.items[j] = (prob, params[i].copy(),
                                        bool(conv[i]))
            return params, conv
        self._set(workers, "solve_em", self.spans.wrap("em_wave",
                                                       recording_solve_em))

        cls = executor.BatchedAligner
        dispatch_shard = cls._dispatch_shard

        def recording_dispatch_shard(aligner, part, dev):
            out = dispatch_shard(aligner, part, dev)
            self.locus_rounds += len(part)
            self._keep_last_rounds(part)
            if self.recording:
                self._keep_dispatch(part, out)
            return out
        self._set(cls, "_dispatch_shard", self.spans.wrap(
            "dispatch", recording_dispatch_shard))
        self._set(executor, "_fetch", self.spans.wrap("fetch",
                                                      executor._fetch))
        self._set(workers, "_fetch", executor._fetch)

        if self.want_launches:
            stutter_emissions = hmm2.stutter_emissions
            segment_kernel = hmm2.segment_kernel

            def k1(codes, blw, blc, brev, blen, periods):
                if self.recording and codes.is_cuda:
                    self.launches["emission"].append(dict(
                        codes=tuple(codes.shape), brev=tuple(brev.shape),
                        itemsize=blc.element_size(), blen=blen.clone(),
                        periods=periods.clone()))
                return stutter_emissions(codes, blw, blc, brev, blen,
                                         periods)

            def k2(*args, R, sr):
                if self.recording and args[0].is_cuda:
                    self.launches["segment"].append(dict(
                        codes=tuple(args[0].shape),
                        itemsize=args[2].element_size(),
                        H=args[6].shape[1], O=args[10].shape[1],
                        hap_opt=args[11].clone(), bounds=args[14].clone(),
                        R=R, sr=sr))
                return segment_kernel(*args, R=R, sr=sr)
            self._set(hmm2, "stutter_emissions", k1)
            self._set(hmm2, "segment_kernel", k2)
        return self

    # ----------------------------------------------------------- samples
    def _keep_dispatch(self, part, out):
        """Keep a seeded sample of this shard's loci (their packed inputs
        on the host, their device results sliced on the device) when the
        reservoir takes the shard, or when it is the largest so far."""
        from hipstr_tpu_torch.pipeline.hap_aligner import stack_arrays
        size = (len(part) * np.asarray(part[0].arrays[0].codes).size
                * part[0].arrays[4].seed_char.shape[0])
        pool = self.dispatches[part[0].statics[7] is not None]
        j = pool.slot()
        big = self.largest is None or size > self.largest[0]
        if j is None and not big:
            return
        k = min(self.loci_per_dispatch, len(part))
        pick = sorted(self.rng.sample(range(len(part)), k))
        items = [part[i] for i in pick]
        res = out if isinstance(out, tuple) else (out,)
        kept = dict(
            arrays=plain(stack_arrays([it.arrays for it in items])),
            statics=tuple(items[0].statics),
            h_real=[it.statics[6] for it in items],
            periods=[it.statics[4] for it in items],
            P_real=[it.statics[5] for it in items],
            order=[it.order for it in items],
            out=tuple(r[pick].clone() for r in res),
            G=len(part))
        if j is not None:
            pool.items[j] = kept
        if big:
            self.largest = (size, kept)

    def _keep_last_rounds(self, part):
        """The packed inputs of each picked locus in this shard: the last
        kept is the round its record came from."""
        for it in part:
            if it.order in self.record_pick:
                self.last_round[it.order] = dict(
                    arrays=plain(it.arrays), statics=tuple(it.statics))

    def kept_dispatches(self) -> List[dict]:
        out = [d for pool in self.dispatches.values() for d in pool.items
               if d is not None]
        if self.largest is not None and not any(
                d is self.largest[1] for d in out):
            out.append(self.largest[1])
        return out


class _Multiprocessing:
    """workers.mp as run_pooled sees it: the real module, but the parent's
    end of each worker's pipe is a _ParentEnd."""

    def __init__(self, real, hooks):
        self.real, self.hooks = real, hooks

    def get_context(self, method=None):
        return _Context(self.real.get_context(method), self.hooks)

    def __getattr__(self, name):
        return getattr(self.real, name)


class _Context:
    def __init__(self, real, hooks):
        self.real, self.hooks = real, hooks

    def Pipe(self, duplex=True):
        a, b = self.real.Pipe(duplex)
        return _ParentEnd(a, self.hooks), b

    def __getattr__(self, name):
        return getattr(self.real, name)


class _ParentEnd:
    """The parent's end of a worker's pipe: stamps each "settled" reply
    with its arrival, and once the hooks `drain`, sends each further
    "prep" with its region stretched past --max-str-len, which the worker
    settles at once without genotyping (the run then ends as soon as the
    loci already handed out have settled, and the workers report their
    timers)."""

    def __init__(self, conn, hooks):
        self.conn, self.hooks = conn, hooks

    def recv(self):
        msg = self.conn.recv()
        if msg[0] == "settled":
            rec = msg[2][2] if msg[2] is not None else None
            self.hooks.settles.append((time.perf_counter(), msg[1], rec))
        return msg

    def send(self, msg):
        if msg[0] == "prep":
            self.hooks.chrom_of[msg[1]] = msg[2].chrom
        if self.hooks.drain and msg[0] == "prep":
            idx, r = msg[1], msg[2]
            self.hooks.skipped.add(idx)
            opts = self.hooks.pipeline.opts
            msg = ("prep", idx, type(r)(r.chrom, r.start,
                                        r.start + opts.max_str_len + 1,
                                        r.period, r.name))
        return self.conn.send(msg)

    def __getattr__(self, name):
        return getattr(self.conn, name)
