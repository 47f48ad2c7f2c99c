"""Share of its roofline that ``fold_flat`` (`csrc/sig_fold.cu`) reached:
the bytes the benchmark counts for the window's fold calls
(`bench.roofline.fold_flat_bytes`, read by wrapping the fold's Python
entry) at the card's memory rate, over the kernel's profiler time.

Nothing is read unless the profiler saw one ``fold_flat`` launch a call
the wrapper counted and the program's own launch counter agrees: bytes
and time must be of the same calls."""
from bench import roofline


def read(view):
    calls = len(view.fold_calls)
    us = view.device_us(lambda name: "fold_flat" in name)
    if (us is None or not calls or view.fold_launches != calls
            or view.device_count(lambda name: "fold_flat" in name) != calls):
        return None
    nbytes = sum(roofline.fold_flat_bytes(*c) for c in view.fold_calls)
    return 100.0 * roofline.bound_s(nbytes) / (us / 1e6)
