"""Iterations the build loop dispatched a build (`build_bisim`'s
``build.dispatch`` tracer events: iteration 0 and every step, those
dispatched past the fixpoint included)."""


def read(view):
    n = sum(1 for e in view.events if e["name"] == "build.dispatch")
    return n / view.builds if n and view.builds else None
