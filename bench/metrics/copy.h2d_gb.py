"""Gigabytes a build copied from the host to the device: the ``bytes`` of
the program's ``build.copy`` events bound for the device (the upload of
the graph's columns), counted by `build_bisim` where it makes the copy."""


def read(view):
    n = sum(e["attrs"]["bytes"] for e in view.events
            if e["name"] == "build.copy" and e["attrs"]["to"] == "device")
    return n / 1e9 / view.builds if n and view.builds else None
