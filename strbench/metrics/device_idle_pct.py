"""The card's idle share of the measured window: 1 - the union of its
kernel and copy intervals (torch.profiler) over the window's length."""


def read(run):
    tr = run["trace"]
    if not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
