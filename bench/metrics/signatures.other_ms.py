"""Device milliseconds a build of every other kernel of the signature
layer: hashing, gathers, scans and scatters, that is each kernel that is
neither a copy, a memset, a sort nor ``fold_flat``, from the profiler."""


def is_other(name: str) -> bool:
    return not (name.startswith(("Memcpy", "Memset"))
                or "sort" in name.lower() or "fold_flat" in name)


def read(view):
    us = view.device_us(is_other)
    return None if us is None or not view.builds else us / 1e3 / view.builds
