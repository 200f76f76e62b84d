"""The pool's workers blocked on their pipes ("Worker idle") over their
wall, first recv to "fin" ("Worker wall"), summed over the workers, whole
traced run.  None where the workers do not report their wall."""


def read(run):
    t = run["timers"]
    wall = t.get("Worker wall (workers)", 0.0)
    if wall <= 0:
        return None
    return 100.0 * t.get("Worker idle (workers)", 0.0) / wall
