"""Device milliseconds a build of sort kernels (the triple sort of
`core/signatures.py` and the sorts of its dense ranks: cub's radix sort
and its helpers, any kernel named for sorting), from the profiler."""


def is_sort(name: str) -> bool:
    return (not name.startswith(("Memcpy", "Memset"))
            and "sort" in name.lower())


def read(view):
    us = view.device_us(is_sort)
    return None if us is None or not view.builds else us / 1e3 / view.builds
