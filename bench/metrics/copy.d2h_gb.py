"""Gigabytes a build copied from the device to the host: the ``bytes`` of
the program's ``build.copy`` events bound for the host (each drain's
block counts and flags, and the pid history's fetch), counted by
`build_bisim` where it makes each copy."""


def read(view):
    n = sum(e["attrs"]["bytes"] for e in view.events
            if e["name"] == "build.copy" and e["attrs"]["to"] == "host")
    return n / 1e9 / view.builds if n and view.builds else None
