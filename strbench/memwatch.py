"""The summed anonymous memory of a process and its descendants, sampled
from a process of its own, so that parsing their smaps takes no time from
the run it measures:

    python3 -m strbench.memwatch <pid>

Commands on standard input, one a line: `on` starts a sample every 2 s,
`off` stops and prints the peak in bytes, the number of samples and the
sources read; `quit`, or the end of standard input, ends it.  Its own
memory is not counted.
"""

from __future__ import annotations

import os
import select
import sys

SOURCES: set = set()


def anon_bytes(pid: int) -> int:
    """The process's anonymous resident memory (its heap, arrays and
    tensors), from smaps; where the host's /proc has no smaps, RssAnon
    from status.  Shared-library pages are left out: the sandboxed kernel
    of the card's host counts every mapped library whole in each process's
    Pss, which a host's real page sharing does not."""
    for name, key in (("smaps", "Anonymous:"), ("status", "RssAnon:")):
        try:
            with open(f"/proc/{pid}/{name}") as fh:
                total = sum(int(line.split()[1]) for line in fh
                            if line.startswith(key))
        except (OSError, ValueError):
            continue
        SOURCES.add(name)
        return total * 1024
    return 0


def descendants(pid: int) -> list:
    """The pids of every process descended from `pid`, by the parent pid
    in each process's stat (a sandboxed kernel lists threads as well as
    child processes in /proc/<pid>/task/*/children)."""
    parent = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                parent[int(name)] = int(fh.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
    out, todo = [], [pid]
    while todo:
        p = todo.pop()
        kids = [c for c, pp in parent.items() if pp == p and c != pid]
        out += kids
        todo += kids
    return sorted(set(out))


def main(pid: int) -> None:
    me, on, peak, n = os.getpid(), False, 0, 0
    while True:
        ready, _, _ = select.select([sys.stdin], [], [], 2.0)
        if ready:
            cmd = sys.stdin.readline().strip()
            if cmd in ("", "quit"):
                return
            if cmd == "on":
                on, peak, n = True, 0, 0
            elif cmd == "off":
                on = False
                print(peak, n, ",".join(sorted(SOURCES)) or "-", flush=True)
        elif on:
            tree = [pid] + [q for q in descendants(pid) if q != me]
            peak = max(peak, sum(anon_bytes(q) for q in tree))
            n += 1


if __name__ == "__main__":
    main(int(sys.argv[1]))
